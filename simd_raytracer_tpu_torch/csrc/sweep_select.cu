// Block-sparse slice sweep select for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of simd_raytracer_tpu/ops/intersect_sweep.py:
// `_kernel_resident` (the whole sliced soup pinned in VMEM, an in-kernel
// while_loop over the tile's schedule; used up to 6 MB) and `_kernel` (the
// streaming variant that DMAs one scheduled slice per grid step for larger
// soups).  On this card the soup stays in device memory whatever its size and
// one slice (9 x 256 floats plus ids and mask, 11 KB) is staged in shared
// memory per step, so one kernel covers both and has no size switch.
//
// What bounds it: arithmetic over the slices a front-to-back walk cannot
// skip (~54 float operations and one IEEE division per pair, built without
// FMA contraction), with the slice reused by 128 rays from shared memory.
// Bytes are not the limit: the soup (4.7 MB for 106.5k triangles) is read
// from L2.  A first design (one 512-thread block per 512-ray tile, walking
// the whole schedule alone) left most SMs idle on the small incoherent
// calls that dominate the paths: a 32-tile call was 32 blocks on 132 SMs.
// This design does three things about that:
//  * a block holds one 128-ray group, a quarter of a 512-ray tile; it walks
//    its tile's schedule (count / order / tnear from _tile_reach and
//    _tile_schedule) with its own early exit over its own 128 rays;
//  * when the groups would not fill the card, each group gets K blocks
//    (gridDim.y, chosen by ops/intersect_sweep.py::sweep_split): block k
//    walks steps j = k, k + K, ..., each share still front to back.  Blocks
//    merge winners with a 64-bit atomicMin on the packed per-ray key
//    (select_common.cuh), seeded by the wrapper with (t_max, IMAX), and
//    read the keys back at every step, so another block's hit tightens
//    their exit too; an any-hit ray that one block decides is published as
//    key 0 and parks in every block;
//  * the next slice is copied with cp.async into the second of two shared
//    buffers while the current one is tested.
// One ray per thread: two rays per thread (half the shared-memory loads per
// pair) measured slower on every call chip_smoke.py times, so it went.
//
// Exactness, as the TPU kernel and the plain torch version:
//  * closest hit merges lexicographically on (t, global id) - slices follow
//    the Morton schedule, so ids are not monotone - seeded with
//    (t_max, IMAX), which makes the window inclusive; the wrapper decodes
//    idx 0 and hit false where nothing was accepted;
//  * any-hit uses the division-free numerator tests;
//  * the early exit only skips slices whose entry bound exceeds every
//    one of the block's rays' best t, so winners do not depend on K;
//  * built with --fmad=false, no fast math.

#include "select_common.cuh"

namespace {

using srt::kBig;

// Rays per tile and triangles per slice: R_TILE and SLICE_SIZE of
// simd_raytracer_tpu_torch/accel/sweep.py; rays per block (GROUP of
// ops/intersect_sweep.py).
constexpr int kRTile = 512;
constexpr int kSlice = 256;
constexpr int kGroup = 128;
constexpr int kGroupsPerTile = kRTile / kGroup;

struct __align__(16) Stage {
  float tri[9 * kSlice];
  int ids[kSlice];
  int mask[kSlice];
};

// Copy slice `s` into `st` with 16-byte cp.async (every slice is a
// contiguous, 16-byte aligned run of each array).
__device__ __forceinline__ void stage(Stage& st, const float* tri_soa,
                                      const int* ids, const int* mask,
                                      size_t s) {
  const float4* tri = reinterpret_cast<const float4*>(tri_soa + s * 9 * kSlice);
  const int4* id4 = reinterpret_cast<const int4*>(ids + s * kSlice);
  const int4* mk4 = reinterpret_cast<const int4*>(mask + s * kSlice);
  for (int c = threadIdx.x; c < 9 * kSlice / 4; c += kGroup)
    srt::cp_async16(reinterpret_cast<float4*>(st.tri) + c, tri + c);
  for (int c = threadIdx.x; c < kSlice / 4; c += kGroup) {
    srt::cp_async16(reinterpret_cast<int4*>(st.ids) + c, id4 + c);
    srt::cp_async16(reinterpret_cast<int4*>(st.mask) + c, mk4 + c);
  }
}

__global__ void __launch_bounds__(kGroup) sweep_select_kernel(
    const int* __restrict__ count,    // (P,)
    const int* __restrict__ order,    // (P, S)
    const float* __restrict__ tnear,  // (P, S)
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tri_soa,  // (S, 9, kSlice)
    const int* __restrict__ ids,        // (S, kSlice), -1 pad
    const int* __restrict__ mask,       // (S, kSlice), 0 = skip
    int n_slices, float eps, int cull, int any_hit,
    unsigned long long* __restrict__ keys) {  // (P * kRTile,), seeded
  __shared__ Stage buf[2];

  const int g = blockIdx.x;
  const int p = g / kGroupsPerTile;
  const int k = blockIdx.y, n_k = gridDim.y;

  const size_t r = static_cast<size_t>(g) * kGroup + threadIdx.x;
  const srt::Ray ray = srt::load_ray(o, d, r);
  unsigned long long pub = keys[r];  // the key this block last read or wrote
  float best_t = pub == 0ull ? -1.f : srt::key_t(pub);  // any-hit: window
  unsigned best_i = srt::key_id(pub);

  const int cnt = count[p];
  const int* ord = order + static_cast<size_t>(p) * n_slices;
  const float* tn = tnear + static_cast<size_t>(p) * n_slices;

  int j = k;
  if (j < cnt) stage(buf[0], tri_soa, ids, mask, ord[j]);
  srt::cp_async_commit();
  for (int it = 0; j < cnt; ++it, j += n_k) {
    if (n_k > 1) {  // another block's hit tightens this block's rays
      const unsigned long long cur = srt::load_key(keys + r);
      if (cur < pub) {
        pub = cur;
        best_t = cur == 0ull ? -1.f : srt::key_t(cur);
        best_i = srt::key_id(cur);
      }
    }
    // Barrier too: every thread is done with the buffer refilled below.
    if (!__syncthreads_or(best_t >= tn[j])) break;
    const int jn = j + n_k;
    if (jn < cnt) stage(buf[(it + 1) & 1], tri_soa, ids, mask, ord[jn]);
    srt::cp_async_commit();
    srt::cp_async_wait<1>();  // this step's slice has landed
    __syncthreads();
    const Stage& st = buf[it & 1];

    if (any_hit) {
      if (best_t < 0.f) continue;  // decided
      for (int l = 0; l < kSlice; ++l) {
        if (st.mask[l] <= 0) continue;
        if (srt::mt_accept_window(ray, srt::load_tri(st.tri, kSlice, l), eps,
                                  cull, best_t)) {
          best_t = -1.f;
          pub = 0ull;
          atomicMin(keys + r, 0ull);
          break;
        }
      }
      continue;
    }

    for (int l = 0; l < kSlice; ++l) {
      if (st.mask[l] <= 0) continue;
      float t;
      if (!srt::mt_accept(ray, srt::load_tri(st.tri, kSlice, l), eps, cull,
                          t) ||
          !(t < kBig))
        continue;
      const unsigned gid = static_cast<unsigned>(st.ids[l]);
      if (t < best_t || (t == best_t && gid < best_i)) {
        best_t = t;
        best_i = gid;
      }
    }
    const unsigned long long mine = srt::pack_key(best_t, best_i);
    if (mine < pub) {
      pub = mine;
      atomicMin(keys + r, mine);
    }
  }
  srt::cp_async_wait<0>();  // no copy may land after the block is gone
}

}  // namespace

// Launches n_tiles * 4 groups x `split` blocks of 128 threads on `stream`,
// merging into the seeded `keys`; returns the cudaError_t of the launch
// (0 = ok).
extern "C" int srt_sweep_select(const void* count, const void* order,
                                const void* tnear, const void* o,
                                const void* d, const void* tri_soa,
                                const void* ids, const void* mask, int n_tiles,
                                int n_slices, int split, float eps, int cull,
                                int any_hit, void* keys, void* stream) {
  const dim3 grid(n_tiles * kGroupsPerTile, split);
  sweep_select_kernel<<<grid, kGroup, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(count), static_cast<const int*>(order),
      static_cast<const float*>(tnear), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(tri_soa),
      static_cast<const int*>(ids), static_cast<const int*>(mask), n_slices,
      eps, cull, any_hit, static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}
