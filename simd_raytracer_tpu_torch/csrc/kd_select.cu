// kd-tree closest-hit select for Hopper (sm_90a): one thread per ray.
//
// Replaces simd_raytracer_tpu/accel/traverse.py:57 `kd_select`, which is
// jnp code, not a Pallas kernel: it runs every ray in lockstep, one
// while_loop step per popped node, testing each ray at a leaf against
// 64-triangle slices of its leaf.  On the card each step of that loop is
// tens of small launches plus a host sync, so the traversal gets a kernel:
// the reference's own form (kd_tree_simd.hpp:188-228), one ray walking its
// own stack.
//
// What bounds it: arithmetic.  A ray tests the live triangles of the
// leaves it reaches (accel/traverse.py::kd_work_pairs counts them), ~54
// float operations and one IEEE division per pair, against 36 bytes of
// triangle data read through L1/L2; chip_smoke.py states the bound as those
// pairs x 54 over the 67 TFLOP/s float32 peak.
//
// Design, simple first: the node arrays (40 bytes a node, ~12 KB for the
// 299 nodes of the full-size scene) are staged in shared memory once per
// block; the per-thread stack of node ids lives in local memory; leaf
// triangle ids are read from `leaf_tris` and each triangle's v0/e1/e2 from
// a packed (T, 9) soup in device memory.  Rays of one warp sit in leaves of
// very different sizes, so lanes idle while the largest leaf finishes:
// the divergence is measured (PERF.md), not addressed here.
//
// Exactness: winners must equal the plain version
// (simd_raytracer_tpu_torch/accel/traverse.py::kd_select) bit for bit.
// The pair tests are select_common.cuh's (K1's arithmetic); the library is
// built with --fmad=false and IEEE division, so 1/d and (bmin - o) * inv_d
// round as the torch ops do; a NaN slab bound becomes -BIG / +BIG as
// there (fminf/fmaxf would drop the NaN instead).  The prune is inclusive
// (t_near <= best_t) and the merge lexicographic on (t, id), so an equal-t
// triangle with a lower id in a later leaf still wins.  Near-far order
// reads the split axis from child0's box max, as the plain version does.
// There is no t_max and no early exit: the window is emulated by the
// caller (ops/intersect.py::make_select_fn).

#include "select_common.cuh"

namespace {

using srt::kBig;

constexpr int kThreads = 64;   // rays per block
constexpr int kMaxStack = 64;  // ops/intersect_kd.py refuses deeper trees

__device__ __forceinline__ void slab_axis(float o, float inv, float bmin,
                                          float bmax, float& lo, float& hi) {
  const float t0 = (bmin - o) * inv;
  const float t1 = (bmax - o) * inv;
  const bool nan = isnan(t0) || isnan(t1);
  lo = nan ? -kBig : fminf(t0, t1);
  hi = nan ? kBig : fmaxf(t0, t1);
}

__global__ void __launch_bounds__(kThreads)
kd_select_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tri,        // (T, 9) v0 e1 e2
                 const int* __restrict__ mask,         // (T,) 0 = skip
                 const float* __restrict__ node_box,   // (N, 6) min, max
                 const int* __restrict__ node_link,    // (N, 4) c0 c1 leaf -
                 const int* __restrict__ leaf_tris,    // (L, cap), -1 pad
                 int n_rays, int n_nodes, int cap, float eps, int cull,
                 int* __restrict__ out_idx,
                 unsigned char* __restrict__ out_hit) {
  extern __shared__ float smem[];
  float* s_box = smem;
  int* s_link = reinterpret_cast<int*>(smem + 6 * n_nodes);
  for (int k = threadIdx.x; k < 6 * n_nodes; k += kThreads)
    s_box[k] = node_box[k];
  for (int k = threadIdx.x; k < 4 * n_nodes; k += kThreads)
    s_link[k] = node_link[k];
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const srt::Ray ray = srt::load_ray(o, d, r);
  const float inv_x = 1.0f / ray.dx;
  const float inv_y = 1.0f / ray.dy;
  const float inv_z = 1.0f / ray.dz;

  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;
  float best_t = kBig;
  int best_i = static_cast<int>(srt::kIMax);

  while (sp > 0) {
    const int node = stack[--sp];
    const float* box = s_box + 6 * node;
    float lx, hx, ly, hy, lz, hz;
    slab_axis(ray.ox, inv_x, box[0], box[3], lx, hx);
    slab_axis(ray.oy, inv_y, box[1], box[4], ly, hy);
    slab_axis(ray.oz, inv_z, box[2], box[5], lz, hz);
    const float t_near = fmaxf(fmaxf(fmaxf(lx, ly), lz), 0.f);
    const float t_far = fminf(fminf(hx, hy), hz);
    if (!(t_far >= t_near && t_near <= best_t)) continue;

    const int c0 = s_link[4 * node];
    if (c0 < 0) {
      const int* row =
          leaf_tris + static_cast<size_t>(s_link[4 * node + 2]) * cap;
      for (int l = 0; l < cap; ++l) {
        const int t = row[l];
        if (t < 0) break;  // -1 pads only the row's tail
        if (mask[t] <= 0) continue;
        float tt;
        const srt::Tri q = srt::load_tri(tri + 9 * static_cast<size_t>(t), 1, 0);
        if (!srt::mt_accept(ray, q, eps, cull, tt)) continue;
        if (tt < best_t || (tt == best_t && t < best_i)) {
          best_t = tt;
          best_i = t;
        }
      }
    } else {
      const int c1 = s_link[4 * node + 1];
      const float* cbox = s_box + 6 * c0;
      const int axis = cbox[3] != box[3] ? 0 : cbox[4] != box[4] ? 1
                     : cbox[5] != box[5] ? 2 : 0;
      const float d_axis = axis == 0 ? ray.dx : axis == 1 ? ray.dy : ray.dz;
      const bool near_first = d_axis >= 0.f;  // child0 holds the lower half
      stack[sp++] = near_first ? c1 : c0;
      stack[sp++] = near_first ? c0 : c1;
    }
  }

  const bool hit = best_t < kBig;
  out_idx[r] = hit ? best_i : 0;
  out_hit[r] = hit ? 1 : 0;
}

}  // namespace

// Launches ceil(n_rays / 64) blocks of 64 threads on `stream`, each staging
// the n_nodes node records (40 bytes each) in dynamic shared memory;
// returns the cudaError_t of the attribute call or the launch (0 = ok).
extern "C" int srt_kd_select(const void* o, const void* d, const void* tri,
                             const void* mask, const void* node_box,
                             const void* node_link, const void* leaf_tris,
                             int n_rays, int n_nodes, int cap, float eps,
                             int cull, void* idx, void* hit, void* stream) {
  const int smem = n_nodes * 10 * static_cast<int>(sizeof(float));
  const cudaError_t attr = cudaFuncSetAttribute(
      kd_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (n_rays + kThreads - 1) / kThreads;
  kd_select_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tri), static_cast<const int*>(mask),
      static_cast<const float*>(node_box), static_cast<const int*>(node_link),
      static_cast<const int*>(leaf_tris), n_rays, n_nodes, cap, eps, cull,
      static_cast<int*>(idx), static_cast<unsigned char*>(hit));
  return static_cast<int>(cudaGetLastError());
}
