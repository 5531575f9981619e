// The hit record of a closest-hit query for Hopper (sm_90a): everything
// ops/intersect.py::trace makes after the select, forward and backward, one
// launch each:
//
//   trace_record_kernel: one thread a ray.  From the select's winner `idx`
//     and flag `hit` it refines the winner's t, u, v (mt_refine), pins a
//     miss's to (1, 0, 0), makes w, the position and the unit interpolated
//     vertex normal, and gathers the winner's face normal, corner UVs,
//     mesh and material fields: every field of HitRecord;
//   trace_record_grad_kernel: one thread a ray, the reverse of the first.
//     It recomputes the refine and the normal in registers, takes the
//     incoming gradients of t, u, v, w, position, hit_n, face_n, uvs,
//     albedo and ior (any of them absent) back to the ray's origin and
//     direction, and writes the ray's row of triangle-table gradients
//     (v0, e1, e2, vn, face_n, uv: width 27) and of material-table
//     gradients (albedo, ior: width 4) with the material as its key.
//
// ops/intersect.py::_record_grad then sums the rows by triangle and by
// material with the deterministic segmented sum of csrc/gather_grad.cu
// (ops/gather.py::row_sums): one sort an index, where the plain version's
// eight gathers make eight.
//
// Replaces no TPU kernel: the JAX package's trace (simd_raytracer_tpu/ops/
// intersect.py) is jnp code that XLA fuses.  The torch record enqueues some
// 84 small kernels a call (every mul, add, where and gather one launch),
// and in training its autograd graph holds some 96 nodes a call, eight of
// them gathers with a sort each, all enqueued by the host while the card
// waits.  What bounds it: bytes and launches.  A ray reads its ray (24
// bytes), its winner's rows of the tables (some 130 bytes, which stay in
// L2: a scene's tables are a few hundred KB) and writes some 120 bytes of
// record; the backward reads the ray, the winner's rows and some 110 bytes
// of incoming gradients and writes 24 + 108 + 16 + 8 bytes.  The
// arithmetic is about a hundred float operations a ray.
//
// Exactness: the forward must equal the torch record on the card bit for
// bit, so every step is the same float32 operation in the same order (the
// helpers of csrc/shade.cuh: dot3 and cross3 term by term, the reciprocal
// and sqrt as IEEE division and square root, clamp_min propagating NaN);
// the library is built with --fmad=false, so nothing contracts.  The
// backward follows torch's derivative conventions: a `where` passes the
// gradient to the branch it took (the determinant's clamp passes none to
// the determinant; a miss's pinned t, u, v pass none to the refine, while
// its hit_n still carries vn[0]'s gradient with w = 1); clamp_min(x, lo)
// passes it where x >= lo; sqrt's is g / (2 sqrt(x)); the reciprocal's
// -g * (r * r).  Sums are taken in another order than autograd's: the
// gradients are the plain version's up to rounding.

#include "shade.cuh"

namespace {

// clamp_min's floor of the normal's squared length, as torch rounds 1e-18.
constexpr float kNormTiny = static_cast<float>(1e-18);

// A ray's row of triangle-table gradients: the columns of each table.
constexpr int kTriWidth = 27;
constexpr int kColV0 = 0;
constexpr int kColE1 = 3;
constexpr int kColE2 = 6;
constexpr int kColVn = 9;      // (3, 3): corner-major
constexpr int kColFaceN = 18;
constexpr int kColUv = 21;     // (3, 2): corner-major
constexpr int kMatWidth = 4;   // albedo 3, ior 1

// Everything trace_record_kernel reads and writes; mirrored field by field
// by ops/intersect.py::RecordArgs (ctypes).  Row arrays are contiguous.
struct RecordArgs {
  // The rays and the select's result.
  const float* o;  // (n, 3)
  const float* d;  // (n, 3)
  const int* idx;  // (n,) winning triangle, 0 on a miss
  const bool* hit;  // (n,)
  // The triangle tables (T rows) and the material tables (M rows).
  const float* v0;          // (T, 3)
  const float* e1;          // (T, 3)
  const float* e2;          // (T, 3)
  const float* vn;          // (T, 3, 3)
  const float* tri_face_n;  // (T, 3)
  const float* tri_uv;      // (T, 3, 2)
  const int* tri_mat;       // (T,)
  const int* tri_mesh;      // (T,)
  const int* mat_tag;       // (M,)
  const float* mat_albedo;  // (M, 3)
  const float* mat_ior;     // (M,)
  const bool* mat_smooth;   // (M,)
  const int* mat_tex;       // (M,)
  // Outputs, HitRecord's fields (null in the backward, which writes none).
  float* t;
  float* u;
  float* v;
  float* w;
  float* position;  // (n, 3)
  float* hit_n;     // (n, 3)
  float* face_n;    // (n, 3)
  float* uvs;       // (n, 3, 2)
  float* albedo;    // (n, 3)
  float* ior;
  int* tag;         // HitRecord's mat_tag
  bool* smooth;
  int* tex;
  int* mesh_idx;
  int64_t n;
  float eps;  // the determinant's clamp, as torch rounds it
};

// Everything trace_record_grad_kernel reads and writes; mirrored field by
// field by ops/intersect.py::RecordGradArgs (ctypes).
struct RecordGradArgs {
  RecordArgs f;  // the call's inputs, as the forward took them
  // Incoming gradients of the record's float fields; null where none came.
  const float* g_t;
  const float* g_u;
  const float* g_v;
  const float* g_w;
  const float* g_position;  // (n, 3)
  const float* g_hit_n;     // (n, 3)
  const float* g_face_n;    // (n, 3)
  const float* g_uvs;       // (n, 3, 2)
  const float* g_albedo;    // (n, 3)
  const float* g_ior;
  // Outputs; null where not wanted.
  float* g_o;          // (n, 3)
  float* g_d;          // (n, 3)
  float* tri_grad;     // (n, kTriWidth), keyed by idx
  float* mat_grad;     // (n, kMatWidth), keyed by mat_key
  int64_t* mat_key;    // (n,), with mat_grad
};

// A table row read through the read-only cache.
__device__ __forceinline__ V3 ldg3(const float* __restrict__ p, int64_t i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ float load_or0(const float* __restrict__ p,
                                          int64_t i) {
  return p ? p[i] : 0.0f;
}

__device__ __forceinline__ V3 load3_or0(const float* __restrict__ p,
                                        int64_t i) {
  return p ? load3(p, i) : V3{0.0f, 0.0f, 0.0f};
}

// ops/intersect.py::mt_refine for one ray and its triangle, with what its
// backward needs.
struct Refine {
  V3 pvec, tvec, qvec;
  float inv_det;
  bool ok;  // |det| > eps: the determinant was not clamped
  float t, u, v;
};

__device__ __forceinline__ Refine refine(V3 o, V3 d, V3 v0, V3 e1, V3 e2,
                                         float eps) {
  Refine r;
  r.pvec = cross3(d, e2);
  const float det = dot3(e1, r.pvec);
  r.ok = fabsf(det) > eps;
  r.inv_det = 1.0f / (r.ok ? det : eps);
  r.tvec = sub(o, v0);
  r.u = dot3(r.tvec, r.pvec) * r.inv_det;
  r.qvec = cross3(r.tvec, e1);
  r.v = dot3(d, r.qvec) * r.inv_det;
  r.t = dot3(e2, r.qvec) * r.inv_det;
  return r;
}

// The record's interpolated normal from the pinned u, v, w.
struct Normal {
  V3 vn0, vn1, vn2;  // the winner's corner normals
  V3 n;              // u vn1 + v vn2 + w vn0
  float sq;          // n.n
  float inv_len;     // 1 / sqrt(clamp_min(sq, 1e-18))
};

__device__ __forceinline__ Normal normal(const float* __restrict__ vn,
                                         int64_t g, float u, float v,
                                         float w) {
  Normal m;
  m.vn0 = ldg3(vn, 3 * g);
  m.vn1 = ldg3(vn, 3 * g + 1);
  m.vn2 = ldg3(vn, 3 * g + 2);
  m.n = add(add(scale(u, m.vn1), scale(v, m.vn2)), scale(w, m.vn0));
  m.sq = dot3(m.n, m.n);
  m.inv_len = 1.0f / sqrtf(clamp_min(m.sq, kNormTiny));
  return m;
}

__global__ void __launch_bounds__(kThreads)
trace_record_kernel(const RecordArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t g = a.idx[i];
  const bool hit = a.hit[i];
  const V3 o = load3(a.o, i);
  const V3 d = load3(a.d, i);
  const Refine r = refine(o, d, ldg3(a.v0, g), ldg3(a.e1, g), ldg3(a.e2, g),
                          a.eps);
  const float t = hit ? r.t : 1.0f;
  const float u = hit ? r.u : 0.0f;
  const float v = hit ? r.v : 0.0f;
  const float w = (1.0f - u) - v;
  const Normal m = normal(a.vn, g, u, v, w);
  a.t[i] = t;
  a.u[i] = u;
  a.v[i] = v;
  a.w[i] = w;
  store3(a.position, i, offset(o, t, d));
  store3(a.hit_n, i, scale(m.inv_len, m.n));
  store3(a.face_n, i, ldg3(a.tri_face_n, g));
  for (int k = 0; k < 6; ++k) a.uvs[6 * i + k] = __ldg(a.tri_uv + 6 * g + k);
  const int mat = __ldg(a.tri_mat + g);
  a.tag[i] = __ldg(a.mat_tag + mat);
  store3(a.albedo, i, ldg3(a.mat_albedo, mat));
  a.ior[i] = __ldg(a.mat_ior + mat);
  a.smooth[i] = a.mat_smooth[mat];
  a.tex[i] = __ldg(a.mat_tex + mat);
  a.mesh_idx[i] = __ldg(a.tri_mesh + g);
}

__global__ void __launch_bounds__(kThreads)
trace_record_grad_kernel(const RecordGradArgs a) {
  const RecordArgs& f = a.f;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= f.n) return;
  const int64_t g = f.idx[i];
  const bool hit = f.hit[i];
  const V3 o = load3(f.o, i);
  const V3 d = load3(f.d, i);
  const V3 v0 = ldg3(f.v0, g), e1 = ldg3(f.e1, g), e2 = ldg3(f.e2, g);
  const Refine r = refine(o, d, v0, e1, e2, f.eps);
  const float t = hit ? r.t : 1.0f;
  const float u = hit ? r.u : 0.0f;
  const float v = hit ? r.v : 0.0f;
  const float w = (1.0f - u) - v;
  const Normal m = normal(f.vn, g, u, v, w);

  // hit_n = n * inv_len, inv_len = 1 / s, s = sqrt(clamp_min(n.n, tiny)).
  const V3 g_hn = load3_or0(a.g_hit_n, i);
  V3 g_n = scale(m.inv_len, g_hn);
  const float g_inv = dot3(g_hn, m.n);
  const float s = sqrtf(clamp_min(m.sq, kNormTiny));
  const float g_s = -g_inv * (m.inv_len * m.inv_len);
  const float g_sq = m.sq >= kNormTiny ? g_s / (2.0f * s) : 0.0f;
  g_n = add(g_n, add(scale(g_sq, m.n), scale(g_sq, m.n)));

  // n = u vn1 + v vn2 + w vn0.
  float g_u = load_or0(a.g_u, i) + dot3(g_n, m.vn1);
  float g_v = load_or0(a.g_v, i) + dot3(g_n, m.vn2);
  const float g_w = load_or0(a.g_w, i) + dot3(g_n, m.vn0);

  // position = o + t d.
  const V3 g_pos = load3_or0(a.g_position, i);
  V3 g_o = g_pos;
  V3 g_d = scale(t, g_pos);
  float g_t = load_or0(a.g_t, i) + dot3(g_pos, d);

  // w = 1 - u - v.
  g_u = g_u - g_w;
  g_v = g_v - g_w;

  V3 g_v0{0.0f, 0.0f, 0.0f}, g_e1{0.0f, 0.0f, 0.0f}, g_e2{0.0f, 0.0f, 0.0f};
  if (hit) {  // a miss's pinned t, u, v pass nothing to the refine
    // u = (tvec.pvec) inv, v = (d.qvec) inv, t = (e2.qvec) inv.
    const float g_inv_det = g_u * dot3(r.tvec, r.pvec) +
                            g_v * dot3(d, r.qvec) + g_t * dot3(e2, r.qvec);
    const float gu = g_u * r.inv_det, gv = g_v * r.inv_det,
                gt = g_t * r.inv_det;
    V3 g_tvec = scale(gu, r.pvec);
    V3 g_pvec = scale(gu, r.tvec);
    g_d = add(g_d, scale(gv, r.qvec));
    V3 g_qvec = scale(gv, d);
    g_e2 = scale(gt, r.qvec);
    g_qvec = add(g_qvec, scale(gt, e2));
    // inv_det = 1 / where(ok, det, eps); det = e1.pvec.
    const float g_det = r.ok ? -g_inv_det * (r.inv_det * r.inv_det) : 0.0f;
    g_e1 = scale(g_det, r.pvec);
    g_pvec = add(g_pvec, scale(g_det, e1));
    // qvec = tvec x e1; pvec = d x e2 (a x b: b x g to a, g x a to b).
    g_tvec = add(g_tvec, cross3(e1, g_qvec));
    g_e1 = add(g_e1, cross3(g_qvec, r.tvec));
    g_d = add(g_d, cross3(e2, g_pvec));
    g_e2 = add(g_e2, cross3(g_pvec, d));
    // tvec = o - v0.
    g_o = add(g_o, g_tvec);
    g_v0 = neg(g_tvec);
  }
  if (a.g_o) store3(a.g_o, i, g_o);
  if (a.g_d) store3(a.g_d, i, g_d);
  if (a.tri_grad) {
    float* row = a.tri_grad + kTriWidth * i;
    store3(row + kColV0, 0, g_v0);
    store3(row + kColE1, 0, g_e1);
    store3(row + kColE2, 0, g_e2);
    store3(row + kColVn, 0, scale(w, g_n));
    store3(row + kColVn, 1, scale(u, g_n));
    store3(row + kColVn, 2, scale(v, g_n));
    store3(row + kColFaceN, 0, load3_or0(a.g_face_n, i));
    for (int k = 0; k < 6; ++k)
      row[kColUv + k] = a.g_uvs ? a.g_uvs[6 * i + k] : 0.0f;
  }
  if (a.mat_grad) {
    float* row = a.mat_grad + kMatWidth * i;
    store3(row, 0, load3_or0(a.g_albedo, i));
    row[3] = load_or0(a.g_ior, i);
    a.mat_key[i] = __ldg(f.tri_mat + g);
  }
}

}  // namespace

// The record of the n >= 1 rays of `args` (ops/intersect.py::RecordArgs,
// by reference) on `stream`, ceil(n / 256) blocks of 256 threads: every
// output field written.  Returns the launch's cudaError_t.
extern "C" int srt_trace_record(const void* args, void* stream) {
  const auto& a = *static_cast<const RecordArgs*>(args);
  trace_record_kernel<<<blocks(a.n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward of srt_trace_record for the n >= 1 rays of `args`
// (ops/intersect.py::RecordGradArgs, by reference): each non-null output
// written for every ray.  Returns the launch's cudaError_t.
extern "C" int srt_trace_record_grad(const void* args, void* stream) {
  const auto& a = *static_cast<const RecordGradArgs*>(args);
  trace_record_grad_kernel<<<blocks(a.f.n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(RecordArgs) and sizeof(RecordGradArgs), which the binding holds
// ops/intersect.py's ctypes mirrors to.
extern "C" long long srt_trace_args_size() { return sizeof(RecordArgs); }

extern "C" long long srt_trace_grad_args_size() {
  return sizeof(RecordGradArgs);
}
