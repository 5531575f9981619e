// Brute-force Moller-Trumbore select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simd_raytracer_tpu/ops/intersect_pallas.py
// `_kernel` (reached through `_select_call` and `mt_select_pallas`).  The TPU
// kernel tests a (512 rays x 512 triangles) block per grid step on the VPU
// lanes and carries per-ray winners in VMEM scratch across the sequential
// triangle-block grid dimension.  Blocks here run in parallel and carry
// nothing between them.
//
// What bounds it: arithmetic.  Each (ray, triangle) pair costs ~54 float
// operations and one IEEE division (no FMA contraction) against 40 bytes
// of triangle data that every ray of the block reuses from shared memory,
// so device memory traffic is small and the FP32 pipes and branch
// divergence set the time.  A first design (one block per 128 rays, each
// walking every triangle) ran a 16,384-ray call as 128 blocks of 4 warps,
// about one per SM.  This design splits the triangle range over a second
// grid dimension (gridDim.y, chosen by ops/intersect_brute.py::k1_split),
// so that such a call runs several blocks per SM; each block stages
// 256-triangle tiles of its share in shared memory as SoA rows (every
// thread reads the same word per step: a broadcast) and the blocks merge
// winners with a 64-bit atomicMin on the packed per-ray key of
// select_common.cuh, seeded by the wrapper with (bits(BIG), IMAX).  Any-hit
// queries publish a decided ray as key 0; blocks poll the keys at each
// tile boundary and stop once all of their rays are decided.  One ray per
// thread: two rays per thread (half the shared-memory loads per pair)
// measured slower on every call chip_smoke.py times, so it went.
//
// Exactness: winners must equal the plain torch version (one op per
// arithmetic step), so the library is built with --fmad=false and without
// fast math; `1.0f / det` stays an IEEE division.  Within a block lanes run
// in ascending triangle index with a strict `<` merge, and across blocks
// the key merge takes the lowest index on exact t ties, as the TPU kernel's
// min-lane pick does.  The closest winner is kept over all triangles, even
// beyond the window: the wrapper decodes hit = best t <= t_max.

#include "select_common.cuh"

namespace {

using srt::kBig;

constexpr int kRays = 128;  // rays per block
constexpr int kTile = 256;  // triangles staged per step (10 KB)

__global__ void __launch_bounds__(kRays)
mt_select_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmax,
                 const float* __restrict__ tri,  // (9, n_tris) SoA
                 const int* __restrict__ mask,   // (n_tris,) 0 = skip
                 int n_rays, int n_tris, int tiles_per_block, float eps,
                 int cull, int any_hit,
                 unsigned long long* __restrict__ keys) {  // (n_rays,)
  __shared__ float s_tri[9 * kTile];
  __shared__ int s_mask[kTile];

  const int r = blockIdx.x * kRays + threadIdx.x;
  const bool active = r < n_rays;
  const srt::Ray ray = active ? srt::load_ray(o, d, r)
                              : srt::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  const float tm = active ? tmax[r] : 0.f;
  float best_t = kBig;
  unsigned best_i = srt::kIMax;
  // Any-hit: a ray is done once found (here or, per its key, elsewhere).
  // Threads past n_rays (the last block rounds up to 128) are done from
  // the start in both modes: they test nothing and never touch `keys`.
  bool done = !active;

  const int n_tiles = (n_tris + kTile - 1) / kTile;
  const int first = blockIdx.y * tiles_per_block;
  const int last = min(first + tiles_per_block, n_tiles);
  for (int tile = first; tile < last; ++tile) {
    const int base = tile * kTile;
    // The barrier also frees the previous tile for overwriting.
    if (any_hit) {
      if (!done && srt::load_key(keys + r) == 0ull) done = true;
      if (__syncthreads_and(done)) break;
    } else {
      __syncthreads();
    }
    const int n = min(kTile, n_tris - base);
    for (int k = threadIdx.x; k < 9 * kTile; k += kRays) {
      const int row = k / kTile, col = k % kTile;
      s_tri[k] = col < n ? tri[static_cast<size_t>(row) * n_tris + base + col]
                         : 0.f;
    }
    for (int k = threadIdx.x; k < kTile; k += kRays) {
      s_mask[k] = k < n ? mask[base + k] : 0;
    }
    __syncthreads();
    if (done) continue;

    for (int l = 0; l < n; ++l) {
      if (s_mask[l] <= 0) continue;
      float t;
      if (!srt::mt_accept(ray, srt::load_tri(s_tri, kTile, l), eps, cull, t))
        continue;
      if (any_hit) {
        if (t <= tm) {  // inclusive window
          done = true;
          atomicMin(keys + r, 0ull);
          break;
        }
      } else if (t < best_t) {
        best_t = t;
        best_i = static_cast<unsigned>(base + l);
      }
    }
  }

  if (active && !any_hit && best_i != srt::kIMax)
    atomicMin(keys + r, srt::pack_key(best_t, best_i));
}

}  // namespace

// Launches ceil(n_rays / 128) x `split` blocks of 128 threads on `stream`,
// each block taking a share of the triangle tiles, merging into the seeded
// `keys`; returns the cudaError_t of the launch (0 = ok).
extern "C" int srt_mt_select(const void* o, const void* d, const void* tmax,
                             const void* tri, const void* mask, int n_rays,
                             int n_tris, int split, float eps, int cull,
                             int any_hit, void* keys, void* stream) {
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  const dim3 grid((n_rays + kRays - 1) / kRays, split);
  mt_select_kernel<<<grid, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), static_cast<const float*>(tri),
      static_cast<const int*>(mask), n_rays, n_tris,
      (n_tiles + split - 1) / split, eps, cull, any_hit,
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}
