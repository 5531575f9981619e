// kd-tree closest-hit select for Hopper (sm_90a): each ray walks its own
// stack, and the rays of a block share every leaf's triangles through
// shared memory.
//
// Replaces simd_raytracer_tpu/accel/traverse.py:57 `kd_select`, which is
// jnp code, not a Pallas kernel: it runs every ray in lockstep, one
// while_loop step per popped node, testing each ray at a leaf against
// 64-triangle slices of its leaf.  On the card each step of that loop is
// tens of small launches plus a host sync, so the traversal gets a kernel.
//
// What bounds it: arithmetic.  A ray tests the live triangles of the
// leaves it reaches (accel/traverse.py::kd_work_pairs counts them), ~54
// float operations and one IEEE division per pair; chip_smoke.py states
// the bound as those pairs x 54 over the 67 TFLOP/s float32 peak.  Few
// large leaves hold the work (the full-size scene: 150 leaves of 8 to
// 3,937 triangles, median 636), so the walk is K1's kind of work inside a
// kd traversal.  A first design (one thread per ray reading its own
// triangles from device memory) reached under 1% of that bound.  What this
// design does about each cause:
//  * no reuse: the wrapper packs the leaves' triangles once per frame,
//    contiguously in leaf order as SoA tiles of kTile (ops/intersect_kd.py::
//    pack_kd).  A block holds R coherent rays (consecutive ids of a chunk;
//    bucket tiles make them neighbours on screen) and runs leaf rounds: it
//    picks the lowest leaf id that any of its rays waits on, stages that
//    leaf tile by tile in shared memory (cp.async, double-buffered), and
//    every ray waiting on it tests every staged triangle from there (a
//    broadcast), as K1 does.  The triangle mask is read once per staged
//    triangle and block, not once per ray;
//  * occupancy: each ray gets G lanes (template parameter) that split a
//    staged tile (lane j takes triangles j, j + G, ...) and reduce their
//    (t, id) with __shfl_xor_sync, so a 16,384-ray call runs G times the
//    warps of one thread per ray.  The wrapper launches (R, G) = (16, 8),
//    the fastest of the instantiated shapes on the calls chip_smoke.py
//    times (PERF.md); each thread loads the ids of its tile entries two
//    tiles ahead and their mask words one tile ahead, so the staging waits
//    on no load;
//  * leaf sizes: a leaf is tested by all rays that wait on it at once, in
//    tiles, so a large leaf no longer holds one lane while its warp idles;
//    rays that wait on other leaves idle for the round instead (the
//    optional counter measures it: pair slots run over pair tests needed);
//  * packing per call: the pack is bound once per frame and geometry.
//
// Node records (40 bytes a node) are read from device memory through the
// read-only cache, so the kernel walks a tree of any size the stack allows
// and its shared memory is the two staging tiles alone.  (A shared-memory
// copy of a table that fits timed the same on the H100, within run-to-run
// spread: PERF.md §6.)
//
// Exactness: winners must equal the plain version
// (simd_raytracer_tpu_torch/accel/traverse.py::kd_select) bit for bit.
// Each ray walks inner nodes exactly as the plain walk does (the same slab
// arithmetic, a NaN slab bound becomes -BIG / +BIG as there, the inclusive
// prune t_near <= best_t against its own best t, near child last with the
// split axis read from child0's box max) until it pops a leaf that passes
// its test; it waits there, without walking on, until its block's round of
// that leaf, so it visits exactly the leaves of its own walk in the same
// order with the same best t.  Within a leaf the lexicographic (t, id)
// minimum does not depend on the order of the tests, and the merge into the
// ray's best is the plain walk's.  The pair tests are select_common.cuh's;
// the library is built with --fmad=false and IEEE division.  There is no
// t_max and no early exit: the window is emulated by the caller
// (ops/intersect.py::make_select_fn).

#include <climits>

#include "select_common.cuh"

namespace {

using srt::kBig;

// Triangles per staged tile: KD_TILE of ops/intersect_kd.py, which packs
// every leaf to a multiple of it.
constexpr int kTile = 128;
constexpr int kMaxStack = 64;  // ops/intersect_kd.py refuses deeper trees

struct __align__(16) Stage {
  float tri[9 * kTile];  // v0 e1 e2 rows
  int id[kTile];         // triangle id, -1 where masked out or padding
};

__device__ __forceinline__ void slab_axis(float o, float inv, float bmin,
                                          float bmax, float& lo, float& hi) {
  const float t0 = (bmin - o) * inv;
  const float t1 = (bmax - o) * inv;
  const bool nan = isnan(t0) || isnan(t1);
  lo = nan ? -kBig : fminf(t0, t1);
  hi = nan ? kBig : fmaxf(t0, t1);
}

// The id of entry e of tile t of the leaf whose `len` references start at
// packed tile `first`; -1 for padding and past the leaf.
__device__ __forceinline__ int raw_id(const int* ids, size_t first, int len,
                                      int t, int e) {
  return e < kTile && t * kTile + e < len
             ? __ldg(ids + (first + t) * kTile + e) : -1;
}

template <int kThreads>
__device__ __forceinline__ void stage_floats(Stage& st, const float* tri,
                                             size_t tile) {
  const float4* src = reinterpret_cast<const float4*>(tri + tile * 9 * kTile);
  float4* dst = reinterpret_cast<float4*>(st.tri);
  for (int c = threadIdx.x; c < 9 * kTile / 4; c += kThreads)
    srt::cp_async16(dst + c, src + c);
}

template <int R, int G>
__global__ void __launch_bounds__(R * G)
kd_select_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tri,        // (tiles, 9, kTile)
                 const int* __restrict__ ids,          // (tiles, kTile)
                 const int* __restrict__ mask,         // (T,) 0 = skip
                 const int* __restrict__ leaf_tile,    // (L,) first tile
                 const int* __restrict__ leaf_len,     // (L,) references
                 const float* __restrict__ node_box,   // (N, 6) min, max
                 const int* __restrict__ node_link,    // (N, 4) c0 c1 leaf -
                 int n_rays, float eps, int cull,
                 int* __restrict__ out_idx,
                 unsigned char* __restrict__ out_hit,
                 unsigned long long* __restrict__ counter) {
  constexpr int kThreads = R * G;
  // Tile entries whose id and mask each thread loads.
  constexpr int kPer = (kTile + kThreads - 1) / kThreads;
  static_assert(kThreads % 32 == 0 && 32 % G == 0,
                "whole warps; a ray's lanes lie in one warp");
  extern __shared__ float4 smem4[];
  Stage* stage = reinterpret_cast<Stage*>(smem4);
  // The leaf of the round, alternating between two slots so that
  // resetting the next round's slot cannot meet a late read of this one.
  __shared__ int s_leaf[2];
  __shared__ int s_live;  // live triangles staged this round (counter)

  if (threadIdx.x == 0) {
    s_leaf[0] = INT_MAX;
    s_live = 0;
  }

  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * R + threadIdx.x / G;
  const bool active = r < n_rays;
  const srt::Ray ray = active ? srt::load_ray(o, d, r)
                              : srt::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  const float inv_x = 1.0f / ray.dx;
  const float inv_y = 1.0f / ray.dy;
  const float inv_z = 1.0f / ray.dz;

  int stack[kMaxStack];
  int sp = active ? 1 : 0;
  stack[0] = 0;
  float best_t = kBig;
  int best_i = INT_MAX;
  int pending = -1;  // the leaf this ray waits on
  unsigned long long staged = 0, slots = 0, tested = 0;  // thread 0
  const int block_rays = min(R, n_rays - static_cast<int>(blockIdx.x) * R);
  __syncthreads();

  for (int it = 0;; ++it) {
    // Walk until a leaf that passes the test, or the stack is empty.
    while (pending < 0 && sp > 0) {
      const int node = stack[--sp];
      const float* box = node_box + 6 * node;
      const float bx1 = __ldg(box + 3);
      const float by1 = __ldg(box + 4);
      const float bz1 = __ldg(box + 5);
      float lx, hx, ly, hy, lz, hz;
      slab_axis(ray.ox, inv_x, __ldg(box), bx1, lx, hx);
      slab_axis(ray.oy, inv_y, __ldg(box + 1), by1, ly, hy);
      slab_axis(ray.oz, inv_z, __ldg(box + 2), bz1, lz, hz);
      const float t_near = fmaxf(fmaxf(fmaxf(lx, ly), lz), 0.f);
      const float t_far = fminf(fminf(hx, hy), hz);
      if (!(t_far >= t_near && t_near <= best_t)) continue;
      const int* link = node_link + 4 * node;
      const int c0 = __ldg(link);
      if (c0 < 0) {
        pending = __ldg(link + 2);
        break;
      }
      const int c1 = __ldg(link + 1);
      const float* cbox = node_box + 6 * c0;
      const int axis = __ldg(cbox + 3) != bx1 ? 0
                     : __ldg(cbox + 4) != by1 ? 1
                     : __ldg(cbox + 5) != bz1 ? 2 : 0;
      const float d_axis = axis == 0 ? ray.dx : axis == 1 ? ray.dy : ray.dz;
      const bool near_first = d_axis >= 0.f;  // child0 holds the lower half
      stack[sp++] = near_first ? c1 : c0;
      stack[sp++] = near_first ? c0 : c1;
    }

    // The round's leaf: the lowest one any ray of the block waits on.
    const int slot = it & 1;
    if (pending >= 0 && lane == 0) atomicMin(&s_leaf[slot], pending);
    __syncthreads();
    const int leaf = s_leaf[slot];
    if (leaf == INT_MAX) break;  // no ray waits and none walks on
    if (threadIdx.x == 0) s_leaf[slot ^ 1] = INT_MAX;
    const bool mine = pending == leaf;

    const int len = __ldg(leaf_len + leaf);
    const size_t first = __ldg(leaf_tile + leaf);
    const int n_tiles = (len + kTile - 1) / kTile;
    // At least one step, so that every round passes a barrier after the
    // slot reset above.
    const int steps = max(n_tiles, 1);
    // This thread's entries of the tile to be stored next (raw ids and
    // their mask words) and of the one after: an id is loaded two steps
    // before its tile is tested and its mask word one step before, so
    // neither load waits in the loop.
    int id_next[kPer], mask_next[kPer], id_later[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      id_next[j] = raw_id(ids, first, len, 0, e);
      mask_next[j] = id_next[j] >= 0 ? __ldg(mask + id_next[j]) : 0;
      id_later[j] = raw_id(ids, first, len, 1, e);
    }
    if (n_tiles > 0) stage_floats<kThreads>(stage[0], tri, first);
    srt::cp_async_commit();

    float lt = kBig;
    int li = INT_MAX;
    int n_mine = 0;  // rays of the round (counter)
    for (int k = 0; k < steps; ++k) {
      Stage& st = stage[k & 1];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = threadIdx.x + j * kThreads;
        const int id = mask_next[j] > 0 ? id_next[j] : -1;
        if (e < kTile) st.id[e] = id;
        if (counter && id >= 0) atomicAdd(&s_live, 1);
      }
      srt::cp_async_wait<0>();
      // Tile k has landed; every thread is done with tile k - 1's buffer.
      if (counter && k == 0)
        n_mine = __syncthreads_count(mine && lane == 0);
      else
        __syncthreads();
      if (k + 1 < n_tiles)
        stage_floats<kThreads>(stage[(k + 1) & 1], tri, first + k + 1);
      srt::cp_async_commit();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = threadIdx.x + j * kThreads;
        id_next[j] = id_later[j];
        mask_next[j] = id_next[j] >= 0 ? __ldg(mask + id_next[j]) : 0;
        id_later[j] = raw_id(ids, first, len, k + 2, e);
      }
      if (!mine) continue;
      const int n = min(kTile, len - k * kTile);
      for (int l = lane; l < n; l += G) {
        const int id = st.id[l];
        if (id < 0) continue;
        float tt;
        if (!srt::mt_accept(ray, srt::load_tri(st.tri, kTile, l), eps, cull,
                            tt))
          continue;
        if (tt < lt || (tt == lt && id < li)) {
          lt = tt;
          li = id;
        }
      }
    }

    // The ray's lanes agree on the leaf's (t, id) minimum, then merge it.
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, lt, off);
      const int oi = __shfl_xor_sync(0xffffffffu, li, off);
      if (ot < lt || (ot == lt && oi < li)) {
        lt = ot;
        li = oi;
      }
    }
    if (mine) {
      if (lt < best_t || (lt == best_t && li < best_i)) {
        best_t = lt;
        best_i = li;
      }
      pending = -1;
    }
    if (counter && threadIdx.x == 0) {
      // Every staging thread added before the tile loop's last barrier.
      const unsigned long long live = s_live;
      staged += len;
      slots += live * block_rays;
      tested += live * n_mine;
      s_live = 0;
    }
  }
  srt::cp_async_wait<0>();

  if (active && lane == 0) {
    const bool hit = best_t < kBig;
    out_idx[r] = hit ? best_i : 0;
    out_hit[r] = hit ? 1 : 0;
  }
  if (counter && threadIdx.x == 0) {
    atomicAdd(counter, staged);
    atomicAdd(counter + 1, slots);
    atomicAdd(counter + 2, tested);
  }
}

template <int R, int G>
int launch(const float* o, const float* d, const float* tri, const int* ids,
           const int* mask, const int* leaf_tile, const int* leaf_len,
           const float* node_box, const int* node_link, int n_rays,
           float eps, int cull, int* idx, unsigned char* hit,
           unsigned long long* counter, cudaStream_t stream) {
  const int grid = (n_rays + R - 1) / R;
  kd_select_kernel<R, G><<<grid, R * G, 2 * sizeof(Stage), stream>>>(
      o, d, tri, ids, mask, leaf_tile, leaf_len, node_box, node_link, n_rays,
      eps, cull, idx, hit, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches ceil(n_rays / rays_per_block) blocks of rays_per_block * lanes
// threads on `stream`, each staging two triangle tiles (5,120 bytes each)
// in dynamic shared memory and reading the node records from device
// memory.  `counter` (three int64: triangles staged, pair slots run, pair
// tests run) may be null.  (rays_per_block, lanes) is one of the
// instantiated shapes below (ops/intersect_kd.py::KD_SHAPES); returns the
// cudaError_t of the launch (0 = ok).
extern "C" int srt_kd_select(const void* o, const void* d, const void* tri,
                             const void* ids, const void* mask,
                             const void* leaf_tile, const void* leaf_len,
                             const void* node_box, const void* node_link,
                             int n_rays, int rays_per_block, int lanes,
                             float eps, int cull, void* idx, void* hit,
                             void* counter, void* stream) {
#define SRT_KD_SHAPE(R, G)                                                   \
  if (rays_per_block == R && lanes == G)                                     \
    return launch<R, G>(                                                     \
        static_cast<const float*>(o), static_cast<const float*>(d),          \
        static_cast<const float*>(tri), static_cast<const int*>(ids),        \
        static_cast<const int*>(mask), static_cast<const int*>(leaf_tile),   \
        static_cast<const int*>(leaf_len),                                   \
        static_cast<const float*>(node_box),                                 \
        static_cast<const int*>(node_link), n_rays, eps, cull,               \
        static_cast<int*>(idx), static_cast<unsigned char*>(hit),            \
        static_cast<unsigned long long*>(counter),                           \
        static_cast<cudaStream_t>(stream));
  SRT_KD_SHAPE(4, 8)
  SRT_KD_SHAPE(8, 4)
  SRT_KD_SHAPE(8, 8)
  SRT_KD_SHAPE(16, 2)
  SRT_KD_SHAPE(16, 4)
  SRT_KD_SHAPE(16, 8)
  SRT_KD_SHAPE(32, 4)
  SRT_KD_SHAPE(32, 8)
  SRT_KD_SHAPE(64, 8)
  SRT_KD_SHAPE(128, 1)
#undef SRT_KD_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}
