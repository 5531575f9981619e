// The backward of one bounce of shading for Hopper (sm_90a): the gradients
// of csrc/shade.cu's outputs taken back to its inputs, as torch autograd
// takes them through ops/shade.py::shade_reference, in two launches:
//
//   shade_bounce_grad_kernel: one thread a row of the wavefront, the reverse
//     of shade_bounce_kernel.  It recomputes in registers what it needs of
//     the forward (the texture pick, the refraction's normals and angles,
//     the GI frame and directions) and writes the row's gradients of
//     position, hit_n, face_n, albedo, ior, d_in and weight, of rnd_gi where
//     asked, of its factor, and of the texture-table row it read, with that
//     row's key (a tex_color_a row, a tex_color_b row or an atlas texel);
//   shade_lights_grad_kernel: one thread a needed row, the reverse of
//     shade_lights_kernel and shade_factor_kernel over the row's lights in
//     light order.  It adds the row's gradients of position and of hit_n or
//     face_n to what the first launch wrote (each row once: no atomics), and
//     writes each (light, row) pair's gradients of light_pos and
//     light_intensity, light-major, keyed by the light.
//
// ops/shade.py::_bounce_grad sums the keyed table gradients with the
// deterministic segmented sum of csrc/gather_grad.cu (ops/gather.py::
// row_sums), so a step's gradients are the same bits on every run.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp shading
// through XLA.  The torch backward it replaces recomputed the plain shading
// under grad mode (some 440 launches a call) and walked its ~260 autograd
// nodes (one to three launches each), all enqueued by the host while the
// card waited.  What bounds it: bytes and launches, as the forward.  A row
// reads its hit record and incoming gradients (some 250 bytes) and writes
// some 90 bytes of gradients; the arithmetic is a few hundred float
// operations a row, far below the card's rate.
//
// Derivatives follow torch's conventions: a `where` passes the gradient to
// the branch it took and nothing to the other; clamp_min(x, lo) passes it
// where x >= lo; sqrt's is g / (2 sqrt(x)); a / b's is g / b and
// -g * ((a / b) / b); the reciprocal's -g * (r * r).  Comparisons and the
// float -> int casts of the texture lookup and of the roulette's GI pick
// pass nothing, so u, v, w, uvs, tex_param and rnd_coin get no gradient.
// Sums are taken in another order than autograd's: the gradients are the
// plain version's up to rounding.

#include "shade.cuh"

namespace {

// The clamps' floors, as torch rounds the Python numbers.
constexpr float kTiny12 = static_cast<float>(1e-12);
constexpr float kTiny18 = static_cast<float>(1e-18);
constexpr float kTiny20 = static_cast<float>(1e-20);
constexpr float kTiny24 = static_cast<float>(1e-24);

// Everything shade_bounce_grad_kernel reads and writes; mirrored field by
// field by ops/shade.py::BounceGradArgs (ctypes).
struct BounceGradArgs {
  BounceArgs f;  // the call's inputs, as the forward took them
  // Incoming gradients of contrib (n, 3) and of the children's origins,
  // directions (n * k, 3) and weights (n * k,); null where none came.
  const float* g_contrib;
  const float* g_child_o;
  const float* g_child_d;
  const float* g_child_w;
  // The rows' gradients, every element written: (n, 3) and (n,).
  float* g_position;
  float* g_hit_n;
  float* g_face_n;
  float* g_albedo;
  float* g_d_in;
  float* g_ior;
  float* g_weight;
  float* g_factor;  // (n,), or null where no row needed light
  float* g_rnd_gi;  // (n, gi, 2), or null where not asked for
  // The texture tables' gradient a row, or null where not asked for:
  // tex_grad (n, 3) and its key, tex_color_a row x -> x, tex_color_b row x
  // -> n_tex + x, atlas texel t -> 2 n_tex + t; a row that is not textured
  // adds zeros to key 2 n_tex + atlas_rows.
  int64_t* tex_key;
  float* tex_grad;
  int64_t n_tex;
};

__device__ __forceinline__ V3 load3_or_zero(const float* __restrict__ p,
                                            int64_t i) {
  return p != nullptr ? load3(p, i) : V3{0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ float load_or_zero(const float* __restrict__ p,
                                              int64_t i) {
  return p != nullptr ? p[i] : 0.0f;
}

// The gradient at v of safe_normalize(v) = v * (1 / sqrt(max(v.v, 1e-18)))
// for the result's gradient g.
__device__ V3 safe_normalize_grad(V3 v, V3 g) {
  const float q = dot3(v, v);
  const float s = sqrtf(clamp_min(q, kTiny18));
  const float inv = 1.0f / s;
  const float g_s = -dot3(g, v) * (inv * inv);
  const float g_q = q >= kTiny18 ? g_s / (2.0f * s) : 0.0f;
  return add(scale(inv, g), add(scale(g_q, v), scale(g_q, v)));
}

// One child's incoming gradients.
struct ChildGrad {
  V3 o, d;
  float w;
};

__device__ __forceinline__ ChildGrad child_grad(const BounceGradArgs& a,
                                                int64_t slot) {
  return ChildGrad{load3_or_zero(a.g_child_o, slot),
                   load3_or_zero(a.g_child_d, slot),
                   load_or_zero(a.g_child_w, slot)};
}

// The row's gradients being gathered.
struct RowGrad {
  V3 position, hit_n, face_n, albedo, d_in;
  float ior, weight;
};

// The reflective child: origin p + rb * dir, dir = d_in - (2 d_in.n) n.
__device__ void reflective_grad(const BounceGradArgs& a, int64_t first,
                                V3 d_in, V3 hn, RowGrad& g) {
  const ChildGrad c = child_grad(a, first);
  g.position = add(g.position, c.o);
  const V3 g_dir = add(c.d, scale(a.f.reflection_bias, c.o));
  const float t = 2.0f * dot3(d_in, hn);
  const float g_dot = 2.0f * -dot3(g_dir, hn);
  g.d_in = add(g.d_in, add(g_dir, scale(g_dot, hn)));
  g.hit_n = add(g.hit_n, add(scale(-t, g_dir), scale(g_dot, d_in)));
  g.weight = g.weight + c.w;
}

// The refractive children (render.hpp:251-301): the reflection ray, and
// the refraction ray unless the row is under total internal reflection;
// the split weighs them by the pseudo-Fresnel term, the roulette picks one.
__device__ void refractive_grad(const BounceGradArgs& a, int64_t i,
                                int64_t first, V3 d_in, V3 hn, float weight,
                                RowGrad& g) {
  const BounceArgs& f = a.f;
  const V3 zero{0.0f, 0.0f, 0.0f};
  // The forward, as shade_bounce_kernel computes it.
  const bool smooth = f.smooth[i];
  const V3 n_geo = smooth ? hn : load3(f.face_n, i);
  V3 nrm = safe_normalize(n_geo);
  const V3 id = safe_normalize(d_in);
  const bool flip = dot3(id, nrm) > 0.0f;
  if (flip) nrm = neg(nrm);
  const float ior = f.ior[i];
  const float eta_i = flip ? ior : 1.0f;
  const float eta_r = flip ? 1.0f : ior;
  const float cos_i = -dot3(id, nrm);
  const float x2 = 1.0f - cos_i * cos_i;
  const float sin_i = sqrtf(clamp_min(x2, kTiny12));
  const bool tir = (eta_r / clamp_min(eta_i, kTiny20)) < sin_i;
  const float er = clamp_min(eta_r, kTiny20);
  const float sin_r = sin_i * eta_i / er;
  const float y2 = 1.0f - sin_r * sin_r;
  const float cos_r = sqrtf(clamp_min(y2, kTiny12));
  const V3 pv = add(id, scale(cos_i, nrm));
  const V3 perp = safe_normalize(pv);
  const float base = 1.0f - cos_i;
  const float base2 = base * base;
  const float fresnel = 0.5f * (base2 * base2 * base);

  bool reflect = true, refract = !tir;
  int64_t refract_slot = first + 1;
  if (f.roulette) {
    reflect = tir || f.rnd_coin[i] < fresnel;
    refract = !reflect;
    refract_slot = first;
  }
  V3 g_id = zero, g_nrm = zero;
  float g_cos_i = 0.0f, g_sin_i = 0.0f, g_eta_i = 0.0f, g_eta_r = 0.0f,
        g_fresnel = 0.0f;
  if (reflect) {
    // r_dir = id - (2 id.nrm) nrm, origin p + rb * r_dir.
    const ChildGrad c = child_grad(a, first);
    g.position = add(g.position, c.o);
    const V3 g_dir = add(c.d, scale(f.reflection_bias, c.o));
    const float t = 2.0f * dot3(id, nrm);
    const float g_dot = 2.0f * -dot3(g_dir, nrm);
    g_id = add(g_id, add(g_dir, scale(g_dot, nrm)));
    g_nrm = add(g_nrm, add(scale(-t, g_dir), scale(g_dot, id)));
    if (f.roulette || tir) {
      g.weight = g.weight + c.w;
    } else {
      g.weight = g.weight + c.w * fresnel;
      g_fresnel = g_fresnel + c.w * weight;
    }
  }
  if (refract) {
    // t_dir = cos_r * (-nrm) + sin_r * perp, origin p + fb * t_dir.
    const ChildGrad c = child_grad(a, refract_slot);
    g.position = add(g.position, c.o);
    const V3 g_dir = add(c.d, scale(f.refraction_bias, c.o));
    const float g_cos_r = dot3(g_dir, neg(nrm));
    g_nrm = sub(g_nrm, scale(cos_r, g_dir));
    float g_sin_r = dot3(g_dir, perp);
    // perp = safe_normalize(id + cos_i * nrm).
    const V3 g_pv = safe_normalize_grad(pv, scale(sin_r, g_dir));
    g_id = add(g_id, g_pv);
    g_cos_i = g_cos_i + dot3(g_pv, nrm);
    g_nrm = add(g_nrm, scale(cos_i, g_pv));
    // cos_r = sqrt(max(1 - sin_r^2, 1e-12)).
    const float g_y = y2 >= kTiny12 ? g_cos_r / (2.0f * cos_r) : 0.0f;
    g_sin_r = g_sin_r - g_y * sin_r - g_y * sin_r;
    // sin_r = (sin_i * eta_i) / max(eta_r, 1e-20).
    const float g_num = g_sin_r / er;
    if (eta_r >= kTiny20) g_eta_r = -g_sin_r * (sin_r / er);
    g_sin_i = g_sin_i + g_num * eta_i;
    g_eta_i = g_num * sin_i;
    if (f.roulette) {
      g.weight = g.weight + c.w;
    } else {
      g.weight = g.weight + c.w * (1.0f - fresnel);
      g_fresnel = g_fresnel - c.w * weight;
    }
  }
  // fresnel = 0.5 * (base^2 * base^2 * base), base = 1 - cos_i.
  const float g5 = 0.5f * g_fresnel;
  const float g_b4 = g5 * base;
  const float g_b2 = g_b4 * base2 + g_b4 * base2;
  const float g_base = g5 * (base2 * base2) + (g_b2 * base + g_b2 * base);
  g_cos_i = g_cos_i - g_base;
  // sin_i = sqrt(max(1 - cos_i^2, 1e-12)).
  const float g_x = x2 >= kTiny12 ? g_sin_i / (2.0f * sin_i) : 0.0f;
  g_cos_i = g_cos_i - g_x * cos_i - g_x * cos_i;
  // cos_i = -(id . nrm).
  g_id = sub(g_id, scale(g_cos_i, nrm));
  g_nrm = sub(g_nrm, scale(g_cos_i, id));
  g.ior = g.ior + (flip ? g_eta_i : g_eta_r);
  const V3 g_n_geo = safe_normalize_grad(n_geo, flip ? neg(g_nrm) : g_nrm);
  if (smooth) {
    g.hit_n = add(g.hit_n, g_n_geo);
  } else {
    g.face_n = add(g.face_n, g_n_geo);
  }
  g.d_in = add(g.d_in, safe_normalize_grad(d_in, g_id));
}

// The diffuse GI children (render.hpp:151-182): ray s of uniforms
// (r0, r1) leaves p + rb * hn along mat3(right, hn, fwd) v(theta, phi),
// right = safe_normalize(d_in x hn), fwd = right x hn.  The split fills
// slot s with ray s; the roulette slot 0 with the ray its coin picks.
__device__ void gi_grad(const BounceGradArgs& a, int64_t i, int64_t first,
                        V3 d_in, V3 hn, RowGrad& g) {
  const BounceArgs& f = a.f;
  const V3 zero{0.0f, 0.0f, 0.0f};
  const V3 c = cross3(d_in, hn);
  const V3 right = safe_normalize(c);
  const V3 fwd = cross3(right, hn);
  const float* rnd = f.rnd_gi + 2 * f.gi * i;
  float* g_rnd = a.g_rnd_gi != nullptr ? a.g_rnd_gi + 2 * f.gi * i : nullptr;
  V3 g_o = zero, g_right = zero, g_up = zero, g_fwd = zero;
  const int rays = f.roulette ? 1 : f.gi;
  for (int r = 0; r < rays; ++r) {
    const int64_t s =
        f.roulette
            ? clamp(static_cast<int64_t>(f.rnd_coin[i] * f.gi_count), 0,
                    f.gi - 1)
            : r;
    const ChildGrad cg = child_grad(a, first + r);
    g_o = add(g_o, cg.o);
    g.weight = g.weight + (f.roulette ? (cg.w * f.gi_inv) * f.gi_count
                                      : cg.w * f.gi_inv);
    const float theta = f.pi * rnd[2 * s];
    const float phi = f.two_pi * rnd[2 * s + 1];
    const float ct = cosf(theta), st = sinf(theta);
    const float cp = cosf(phi), sp = sinf(phi);
    const V3 v{cp * ct, st, sp * ct};
    g_right = add(g_right, scale(cg.d.x, v));
    g_up = add(g_up, scale(cg.d.y, v));
    g_fwd = add(g_fwd, scale(cg.d.z, v));
    if (g_rnd != nullptr) {
      const V3 g_v = add(add(scale(cg.d.x, right), scale(cg.d.y, hn)),
                         scale(cg.d.z, fwd));
      const float g_ct = g_v.x * cp + g_v.z * sp;
      const float g_theta = g_v.y * ct - g_ct * st;
      const float g_phi = (g_v.z * ct) * cp - (g_v.x * ct) * sp;
      g_rnd[2 * s] = f.pi * g_theta;
      g_rnd[2 * s + 1] = f.two_pi * g_phi;
    }
  }
  g.position = add(g.position, g_o);
  // fwd = right x up, up = hn.
  g_right = add(g_right, cross3(hn, g_fwd));
  g_up = add(g_up, cross3(g_fwd, right));
  g.hit_n = add(g.hit_n, add(scale(f.reflection_bias, g_o), g_up));
  const V3 g_c = safe_normalize_grad(c, g_right);
  g.d_in = add(g.d_in, cross3(hn, g_c));
  g.hit_n = add(g.hit_n, cross3(g_c, d_in));
}

__global__ void __launch_bounds__(kThreads)
shade_bounce_grad_kernel(const BounceGradArgs a) {
  const BounceArgs& f = a.f;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= f.n) return;
  const V3 zero{0.0f, 0.0f, 0.0f};
  const bool hit = f.mask[i];
  const int tag = f.tag[i];
  const float weight = f.weight[i];
  const float hit_f = hit ? 1.0f : 0.0f;
  const float live = weight * hit_f;
  const bool hit_live = hit && weight > 0.0f;
  const V3 albedo = load3(f.albedo, i);
  RowGrad g{zero, zero, zero, zero, zero, 0.0f, 0.0f};

  // contrib = ((live * factor) * ds) * surf + (live * constant) * albedo.
  const V3 gc = load3_or_zero(a.g_contrib, i);
  const float factor = f.factor != nullptr ? f.factor[i] : 0.0f;
  const float ds = tag == kDiffuse ? f.direct_scale : 1.0f;
  const float is_constant = tag == kConstant ? 1.0f : 0.0f;
  const float s = live * factor * ds;
  int pick = kPickA;
  int64_t texel = 0;
  V3 surf = albedo;
  if (tag == kTexture) {
    const int x = f.tex[i];
    pick = texture_pick(f, i, x, &texel);
    surf = pick == kPickA   ? load3(f.tex_color_a, x)
           : pick == kPickB ? load3(f.tex_color_b, x)
                            : load3(f.atlas, texel);
  }
  const V3 g_surf = scale(s, gc);
  const float g_lf = dot3(gc, surf) * ds;
  if (a.g_factor != nullptr) a.g_factor[i] = g_lf * live;
  const float g_live = g_lf * factor + dot3(gc, albedo) * is_constant;
  g.albedo = scale(live * is_constant, gc);
  if (tag != kTexture) g.albedo = add(g.albedo, g_surf);
  g.weight = g_live * hit_f;
  if (a.tex_key != nullptr) {
    const int64_t x = f.tex[i];
    a.tex_key[i] = tag != kTexture    ? 2 * a.n_tex + f.atlas_rows
                   : pick == kPickA   ? x
                   : pick == kPickB   ? a.n_tex + x
                                      : 2 * a.n_tex + texel;
    store3(a.tex_grad, i, tag == kTexture ? g_surf : zero);
  }

  // The children.  Under roulette a row that fills none keeps the empty
  // child, whose origin is the row's position.
  if (a.g_rnd_gi != nullptr)
    for (int q = 0; q < 2 * f.gi; ++q) a.g_rnd_gi[2 * f.gi * i + q] = 0.0f;
  const int64_t first = i * f.k;
  const V3 hn = load3(f.hit_n, i);
  const V3 d_in = load3(f.d_in, i);
  if (hit_live && tag == kReflective) {
    reflective_grad(a, first, d_in, hn, g);
  } else if (hit_live && tag == kRefractive) {
    refractive_grad(a, i, first, d_in, hn, weight, g);
  } else if (hit_live && tag == kDiffuse && f.gi > 0) {
    gi_grad(a, i, first, d_in, hn, g);
  } else if (f.roulette) {
    g.position = add(g.position, load3_or_zero(a.g_child_o, i));
  }

  store3(a.g_position, i, g.position);
  store3(a.g_hit_n, i, g.hit_n);
  store3(a.g_face_n, i, g.face_n);
  store3(a.g_albedo, i, g.albedo);
  store3(a.g_d_in, i, g.d_in);
  a.g_ior[i] = g.ior;
  a.g_weight[i] = g.weight;
}

__global__ void __launch_bounds__(kThreads)
shade_lights_grad_kernel(const int64_t* __restrict__ need, int64_t m,
                         int n_lights, const float* __restrict__ position,
                         const float* __restrict__ hit_n,
                         const float* __restrict__ face_n,
                         const bool* __restrict__ smooth,
                         const float* __restrict__ light_pos,
                         const float* __restrict__ light_intensity,
                         const bool* __restrict__ occ,
                         const float* __restrict__ g_factor, float four_pi,
                         float* __restrict__ g_position,
                         float* __restrict__ g_hit_n,
                         float* __restrict__ g_face_n,
                         int64_t* __restrict__ light_key,
                         float* __restrict__ light_grad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const V3 zero{0.0f, 0.0f, 0.0f};
  const int64_t row = need[i];
  const V3 p = load3(position, row);
  const bool sm = smooth[row];
  const V3 n = sm ? load3(hit_n, row) : load3(face_n, row);
  const float g_term = g_factor[row];
  V3 g_p = zero, g_n = zero;
  for (int l = 0; l < n_lights; ++l) {
    const int64_t j = l * m + i;
    V3 g_lp = zero;
    float g_li = 0.0f;
    if (!occ[j]) {
      // term = falloff * cos_law, as shade_lights_kernel makes it.
      const V3 un = sub(load3(light_pos, l), p);
      const float q = dot3(un, un);
      const float r = sqrtf(clamp_min(q, kTiny24));
      const V3 ldir{un.x / r, un.y / r, un.z / r};
      const float area = four_pi * r * r;
      const float c = dot3(ldir, n);
      const float cos_law = clamp_min(c, 0.0f);
      const float area_c = clamp_min(area, kTiny20);
      const float falloff = light_intensity[l] / area_c;
      const float g_falloff = g_term * cos_law;
      const float g_c = c >= 0.0f ? g_term * falloff : 0.0f;
      g_li = g_falloff / area_c;
      // falloff = intensity / max(area, 1e-20), area = (4 pi r) r.
      const float g_area =
          area >= kTiny20 ? -g_falloff * (falloff / area_c) : 0.0f;
      float g_r = g_area * (four_pi * r) + (g_area * r) * four_pi;
      // cos_law = max(ldir . n, 0), ldir = un / r.
      const V3 g_ldir = scale(g_c, n);
      g_n = add(g_n, scale(g_c, ldir));
      g_r = g_r - (g_ldir.x * (ldir.x / r) + g_ldir.y * (ldir.y / r) +
                   g_ldir.z * (ldir.z / r));
      // r = sqrt(max(un . un, 1e-24)).
      const float g_q = q >= kTiny24 ? g_r / (2.0f * r) : 0.0f;
      g_lp = add(V3{g_ldir.x / r, g_ldir.y / r, g_ldir.z / r},
                 add(scale(g_q, un), scale(g_q, un)));
      g_p = sub(g_p, g_lp);
    }
    if (light_grad != nullptr) {
      light_grad[4 * j] = g_lp.x;
      light_grad[4 * j + 1] = g_lp.y;
      light_grad[4 * j + 2] = g_lp.z;
      light_grad[4 * j + 3] = g_li;
      light_key[j] = l;
    }
  }
  store3(g_position, row, add(load3(g_position, row), g_p));
  float* g_row_n = sm ? g_hit_n : g_face_n;
  store3(g_row_n, row, add(load3(g_row_n, row), g_n));
}

}  // namespace

// The backward of srt_shade_bounce over `args->f.n` >= 1 rows (args: a
// BounceGradArgs).  Returns the launch's cudaError_t (0 = ok).
extern "C" int srt_shade_bounce_grad(const void* args, void* stream) {
  const auto& a = *static_cast<const BounceGradArgs*>(args);
  shade_bounce_grad_kernel<<<blocks(a.f.n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward of srt_shade_lights and srt_shade_factor over the m >= 1
// needed rows (`need`, int64) and their light-major visibility `occ`
// (m * n_lights,): g_factor (n,) is the factor's gradient that
// srt_shade_bounce_grad wrote; each needed row's light gradients are added
// to its rows of g_position and of g_hit_n (smooth) or g_face_n.  Where
// light_grad is not null, pair j's gradients of light_pos and
// light_intensity are light_grad[j] (m * n_lights, 4) with key j / m in
// light_key (m * n_lights,) int64.  Returns the launch's cudaError_t.
extern "C" int srt_shade_lights_grad(
    const void* need, long long m, int n_lights, const void* position,
    const void* hit_n, const void* face_n, const void* smooth,
    const void* light_pos, const void* light_intensity, const void* occ,
    const void* g_factor, float four_pi, void* g_position, void* g_hit_n,
    void* g_face_n, void* light_key, void* light_grad, void* stream) {
  shade_lights_grad_kernel<<<blocks(m), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(need), m, n_lights,
      static_cast<const float*>(position), static_cast<const float*>(hit_n),
      static_cast<const float*>(face_n), static_cast<const bool*>(smooth),
      static_cast<const float*>(light_pos),
      static_cast<const float*>(light_intensity),
      static_cast<const bool*>(occ), static_cast<const float*>(g_factor),
      four_pi, static_cast<float*>(g_position), static_cast<float*>(g_hit_n),
      static_cast<float*>(g_face_n), static_cast<int64_t*>(light_key),
      static_cast<float*>(light_grad));
  return static_cast<int>(cudaGetLastError());
}

// sizeof(BounceGradArgs), which the binding holds ops/shade.py::
// BounceGradArgs to.
extern "C" long long srt_shade_grad_args_size() {
  return sizeof(BounceGradArgs);
}
