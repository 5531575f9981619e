// One bounce of shading for Hopper (sm_90a), forward: the torch op chain
// of ops/shade.py::shade_reference (with models/textures.py::
// sample_texture) in three launches around the unchanged occlusion query.
// Its backward is csrc/shade_grad.cu.
//
// Replaces no TPU kernel: the JAX package's shade (simd_raytracer_tpu/ops/
// shade.py) is jnp code that XLA fuses.  The torch path enqueues some 300
// small elementwise kernels a call (every mul, add, where and gather of the
// shading math one launch), so a frame's card waited on the Python that
// enqueued them.  ops/shade.py::shade runs these kernels on every CUDA
// call instead:
//
//   shade_lights_kernel: one thread a (needed row, light), light-major as
//     direct_light_factor batches them: the shadow ray (origin, direction,
//     window) the occlusion query takes, and the pair's falloff * cos_law;
//   (the occlusion query, ops/shade.py::occluded, as before);
//   shade_factor_kernel: one thread a needed row: the sum over lights of
//     where(occluded, 0, term) in light order, written to its row of the
//     zeroed factor (each row once: no atomics);
//   shade_bounce_kernel: one thread a row of the wavefront: the textures,
//     the direct contribution and the children (the K split slots, or the
//     one roulette pick).
//
// What bounds it: bytes and launches.  A row reads some 130 bytes of its
// hit record and writes its contribution and children (at most 30 bytes a
// slot); the arithmetic (a few hundred float operations a row, the GI
// frame's sin and cos among them) is far below the card's rate, so the
// kernels take microseconds and the host's enqueue of the rest of the
// bounce sets the pace.
//
// Exactness: the results must equal the torch path on the card bit for bit,
// so every step is the same float32 operation in the same order (the
// helpers of csrc/shade.cuh), scalars rounded to float as torch rounds a
// Python number (passed in by the wrapper), a division by a Python scalar
// as torch's CUDA kernel makes it (a multiply by the float reciprocal),
// float -> int casts that truncate, the truncated remainder of the checker,
// cosf and sinf as torch's cos and sin call them.

#include "shade.cuh"

namespace {

// The GI ray of uniforms (r0, r1) in the frame (right, up, fwd).
__device__ __forceinline__ V3 gi_direction(const BounceArgs& a, V3 right,
                                           V3 up, V3 fwd, float r0, float r1) {
  const float theta = a.pi * r0;
  const float phi = a.two_pi * r1;
  const float ct = cosf(theta);
  const float vx = cosf(phi) * ct;
  const float vy = sinf(theta);
  const float vz = sinf(phi) * ct;
  return V3{right.x * vx + right.y * vy + right.z * vz,
            up.x * vx + up.y * vy + up.z * vz,
            fwd.x * vx + fwd.y * vy + fwd.z * vz};
}

struct Child {
  V3 o, d;
  float w;
  bool bg;
};

__device__ __forceinline__ void store_child(const BounceArgs& a, int64_t slot,
                                            const Child& c) {
  store3(a.child_o, slot, c.o);
  store3(a.child_d, slot, c.d);
  a.child_w[slot] = c.w;
  a.child_bg[slot] = c.bg;
}

__global__ void __launch_bounds__(kThreads)
shade_lights_kernel(const int64_t* __restrict__ need, int64_t m,
                    int n_lights, const float* __restrict__ position,
                    const float* __restrict__ hit_n,
                    const float* __restrict__ face_n,
                    const bool* __restrict__ smooth,
                    const float* __restrict__ light_pos,
                    const float* __restrict__ light_intensity,
                    float shadow_bias, float four_pi,
                    float* __restrict__ shadow_o, float* __restrict__ shadow_d,
                    float* __restrict__ max_t, float* __restrict__ term) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= m * n_lights) return;
  const int l = static_cast<int>(j / m);
  const int64_t row = need[j - l * m];
  const V3 p = load3(position, row);
  const V3 un = sub(load3(light_pos, l), p);
  const float r = sqrtf(clamp_min(dot3(un, un), static_cast<float>(1e-24)));
  const V3 ldir{un.x / r, un.y / r, un.z / r};
  const float area = four_pi * r * r;
  const V3 n = smooth[row] ? load3(hit_n, row) : load3(face_n, row);
  const float cos_law = clamp_min(dot3(ldir, n), 0.0f);
  store3(shadow_o, j, offset(p, shadow_bias, ldir));
  store3(shadow_d, j, ldir);
  max_t[j] = cos_law > 0.0f ? r : 0.0f;
  const float falloff =
      light_intensity[l] / clamp_min(area, static_cast<float>(1e-20));
  term[j] = falloff * cos_law;
}

__global__ void __launch_bounds__(kThreads)
shade_factor_kernel(const int64_t* __restrict__ need, int64_t m, int n_lights,
                    const bool* __restrict__ occ,
                    const float* __restrict__ term,
                    float* __restrict__ factor) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  float total = occ[i] ? 0.0f : term[i];
  for (int l = 1; l < n_lights; ++l) {
    const int64_t j = l * m + i;
    total = total + (occ[j] ? 0.0f : term[j]);
  }
  factor[need[i]] = total;
}

__global__ void __launch_bounds__(kThreads)
shade_bounce_kernel(const BounceArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const bool hit = a.mask[i];
  const int tag = a.tag[i];
  const float weight = a.weight[i];
  const float live = weight * (hit ? 1.0f : 0.0f);
  const bool hit_live = hit && weight > 0.0f;
  const V3 p = load3(a.position, i);
  const V3 hn = load3(a.hit_n, i);
  const V3 albedo = load3(a.albedo, i);

  // Direct light and emission.
  const V3 surf = tag == kTexture ? sample_texture(a, i, a.tex[i]) : albedo;
  const float ds = tag == kDiffuse ? a.direct_scale : 1.0f;
  const float f = a.factor != nullptr ? a.factor[i] : 0.0f;
  const float s = live * f * ds;
  const float cst = live * (tag == kConstant ? 1.0f : 0.0f);
  store3(a.contrib, i, add(scale(s, surf), scale(cst, albedo)));

  // Children: every slot starts empty, then the row's material fills its
  // own (the tags exclude each other).
  const int64_t first = i * a.k;
  const Child empty{a.roulette ? p : V3{0.0f, 0.0f, 0.0f},
                    V3{0.0f, 0.0f, -1.0f}, 0.0f, false};
  Child c0 = empty, c1 = empty;
  int filled = 0;  // slots of this row written below
  const V3 d_in = load3(a.d_in, i);
  if (hit_live && tag == kReflective) {
    const V3 dir = sub(d_in, scale(2.0f * dot3(d_in, hn), hn));
    c0 = Child{offset(p, a.reflection_bias, dir), dir, weight, true};
  } else if (hit_live && tag == kRefractive) {
    const V3 n_geo = a.smooth[i] ? hn : load3(a.face_n, i);
    V3 nrm = safe_normalize(n_geo);
    const V3 id = safe_normalize(d_in);
    const bool flip = dot3(id, nrm) > 0.0f;
    if (flip) nrm = neg(nrm);
    const float ior = a.ior[i];
    const float eta_i = flip ? ior : 1.0f;
    const float eta_r = flip ? 1.0f : ior;
    const float cos_i = -dot3(id, nrm);
    const float sin_i =
        sqrtf(clamp_min(1.0f - cos_i * cos_i, static_cast<float>(1e-12)));
    const bool tir =
        (eta_r / clamp_min(eta_i, static_cast<float>(1e-20))) < sin_i;
    const V3 r_dir = sub(id, scale(2.0f * dot3(id, nrm), nrm));
    const Child reflect{offset(p, a.reflection_bias, r_dir), r_dir, weight,
                        false};
    const float sin_r =
        sin_i * eta_i / clamp_min(eta_r, static_cast<float>(1e-20));
    const float cos_r =
        sqrtf(clamp_min(1.0f - sin_r * sin_r, static_cast<float>(1e-12)));
    const V3 perp = safe_normalize(add(id, scale(cos_i, nrm)));
    const V3 t_dir = add(scale(cos_r, neg(nrm)), scale(sin_r, perp));
    const Child refract{offset(p, a.refraction_bias, t_dir), t_dir, weight,
                        false};
    const float base = 1.0f - cos_i;
    const float base2 = base * base;
    const float fresnel = 0.5f * (base2 * base2 * base);
    if (a.roulette) {
      c0 = (tir || a.rnd_coin[i] < fresnel) ? reflect : refract;
    } else {
      c0 = reflect;
      c0.w = tir ? weight : weight * fresnel;
      if (!tir) {
        c1 = refract;
        c1.w = weight * (1.0f - fresnel);
      }
    }
  } else if (hit_live && tag == kDiffuse && a.gi > 0) {
    // The frame is built from the un-normalised incoming direction.
    const V3 right = safe_normalize(cross3(d_in, hn));
    const V3 fwd = cross3(right, hn);
    const V3 o = offset(p, a.reflection_bias, hn);
    const float* rnd = a.rnd_gi + 2 * a.gi * i;
    if (a.roulette) {
      const int64_t j = clamp(
          static_cast<int64_t>(a.rnd_coin[i] * a.gi_count), 0, a.gi - 1);
      c0 = Child{o, gi_direction(a, right, hn, fwd, rnd[2 * j],
                                 rnd[2 * j + 1]),
                 weight * a.gi_count * a.gi_inv, false};
    } else {
      // GI ray s in slot s; a slot past the rays (gi = 1) stays empty.
      const float gw = weight * a.gi_inv;
      for (int sl = 0; sl < a.gi; ++sl)
        store_child(a, first + sl,
                    Child{o, gi_direction(a, right, hn, fwd, rnd[2 * sl],
                                          rnd[2 * sl + 1]),
                          gw, false});
      filled = a.gi;
    }
  }
  if (filled == 0) {
    store_child(a, first, c0);
    filled = 1;
    if (a.k > 1) {
      store_child(a, first + 1, c1);
      filled = 2;
    }
  }
  for (int sl = filled; sl < a.k; ++sl) store_child(a, first + sl, empty);
}

}  // namespace

// The shadow rays of the m needed rows (`need`, int64 row ids) and every
// light, light-major (pair j = light * m + i): origins and directions
// (m * n_lights, 3), windows and falloff * cos_law terms (m * n_lights,).
// position, hit_n, face_n (n, 3) float32 and smooth (n,) bool are the
// whole wavefront's; light_pos (L, 3), light_intensity (L,).  Needs m >= 1.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int srt_shade_lights(const void* need, long long m, int n_lights,
                                const void* position, const void* hit_n,
                                const void* face_n, const void* smooth,
                                const void* light_pos,
                                const void* light_intensity,
                                float shadow_bias, float four_pi,
                                void* shadow_o, void* shadow_d, void* max_t,
                                void* term, void* stream) {
  shade_lights_kernel<<<blocks(m * n_lights), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(need), m, n_lights,
      static_cast<const float*>(position), static_cast<const float*>(hit_n),
      static_cast<const float*>(face_n), static_cast<const bool*>(smooth),
      static_cast<const float*>(light_pos),
      static_cast<const float*>(light_intensity), shadow_bias, four_pi,
      static_cast<float*>(shadow_o), static_cast<float*>(shadow_d),
      static_cast<float*>(max_t), static_cast<float*>(term));
  return static_cast<int>(cudaGetLastError());
}

// factor[need[i]] = sum over lights, in order, of occ ? 0 : term (pairs as
// srt_shade_lights lays them out); the other rows of factor are left as
// they are.  Needs m >= 1.  Returns the launch's cudaError_t.
extern "C" int srt_shade_factor(const void* need, long long m, int n_lights,
                                const void* occ, const void* term,
                                void* factor, void* stream) {
  shade_factor_kernel<<<blocks(m), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(need), m, n_lights,
      static_cast<const bool*>(occ), static_cast<const float*>(term),
      static_cast<float*>(factor));
  return static_cast<int>(cudaGetLastError());
}

// The bounce of `args->n` >= 1 rows: contributions and children, every
// output value written.  Returns the launch's cudaError_t.
extern "C" int srt_shade_bounce(const void* args, void* stream) {
  const auto& a = *static_cast<const BounceArgs*>(args);
  shade_bounce_kernel<<<blocks(a.n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(BounceArgs), which the binding holds ops/shade.py::BounceArgs to.
extern "C" long long srt_shade_args_size() { return sizeof(BounceArgs); }
