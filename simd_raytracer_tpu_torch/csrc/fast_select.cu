// Division-free bilinear select ("fast") for Hopper (sm_90a).
//
// Replaces simd_raytracer_tpu/ops/intersect_mxu.py `mt_select_fast`, jnp code
// that XLA compiles into one fusion on the TPU (no Pallas kernel).  Every
// Moller-Trumbore numerator is a scalar triple product, bilinear in per-ray
// features (the centred origin o, d and c = o x d) and per-triangle
// constants (n = e1 x e2, v0 . n, wu = v0 x e2, wv = e1 x v0, e1, e2, with
// v0 centred on the mean of v0).  The wrapper (ops/intersect_fast.py) builds
// those constants once per frame as a (T padded to kTile, 16) table with the
// torch ops of the plain version; the kernel forms the numerators, runs the
// accept tests on them with no division (signs folded in by sgn(det), the
// optional window as t_num * s <= t_max * |det|) and divides once, t_num /
// det, for an accepted pair's sort key.
//
// What bounds it.  A pair that fails the u test, as 99.7% do, costs about
// 20 instructions: det (5), u_num (11), the cull test and two comparisons
// (chip_smoke.py::FAST_STAGE_OPS charges them).  That is the floor; the
// kernel runs below the instruction rate it allows (PERF.md section 6),
// held by latency: each step's shared loads, the chains of dependent sums
// and the warp vote that ends the step, hidden only by the other warps an
// SM holds.  Shared-memory reads no longer bound it (two, three and four
// rays a thread ran within about a tenth of each other).  The design keeps
// everything but those 20 instructions off the path and gives the chains
// independent work:
//  * register blocking: a thread holds kWidth = 3 consecutive rays
//    (ops/intersect_fast.py::FAST_WIDTH), so one read of a triangle's
//    constants serves three pairs (two and four rays a thread were slower
//    on every call, PERF.md); only d and c = o x d of its rays stay in
//    registers (the rare branch reloads the origin and the window
//    and recomputes det and u_num, the same operations, the same bits), so
//    that more warps fit on an SM;
//  * 16-byte reads in test order: a table row is four float4 words, (n,
//    v0.n) for the cull test, (e2, wu.x) and (wu.y, wu.z, wv.x, wv.y) for the
//    u test, (wv.z, e1) for the v test; all lanes of a warp read the same
//    word (a broadcast), three 16-byte loads for three pairs on the common
//    path, from a shared address held in a register;
//  * two rows a step: their loads and tests are independent work for the
//    latency to hide behind, and one vote serves both;
//  * masked triangles leave the loop: the block compacts each staged tile
//    to its live rows (the mask read in place, one byte a triangle; none =
//    all live), in ascending order, with a ballot and a prefix count a
//    32-triangle chunk, their tile offsets beside them, so a masked
//    triangle costs one byte of a read, not a loop step, and the march's
//    glass probe walks 20,480 triangles, not 106,510.  The pair loop reads
//    the compacted rows at consecutive addresses, so no index load and no
//    address arithmetic stand ahead of a step's loads (a list of offsets
//    into the staged tile would put both there: the compiler rebuilds such
//    a list's address from the thread index on every step);
//  * double-buffered staging: the next tile is copied into shared memory
//    with cp.async while the pair tests run on this one, two barriers a
//    tile (the copy, the compacted rows);
//  * one branch after the common stages: det, cull and u are computed for
//    all of a thread's rays without a branch a pair; the v, t and window
//    tests and the division run under one branch, taken by the warp when
//    a vote finds that any of its pairs passed, so the common path needs
//    no reconvergence.
//    On the common path the sign of det is applied by flipping the sign bit
//    (u_num ^ sign(det), |det|), which equals the multiplication by sgn =
//    +-1 whenever the cull test passed (det is then neither zero nor NaN;
//    culled, det > eps >= 0 and sgn is +1, so nothing is flipped); where
//    it failed the pair is rejected either way.  The branch repeats the
//    plain arithmetic as written, the multiplications by sgn included.
// The tile range of a call is split evenly over gridDim.y by
// ops/intersect_fast.py::fast_split when the ray blocks alone would not
// fill the card; winners merge with a 64-bit atomicMin on the packed (t, id)
// keys of select_common.cuh; any-hit rays publish key 0 and blocks poll the
// keys at each tile boundary and stop once every ray in the block is
// decided.
//
// Exactness: winners equal the plain torch version (one op per arithmetic
// step, left to right as Python adds), so the library is built with
// --fmad=false and IEEE division.  An accepted pair has t_num * s > eps *
// |det| >= 0, so t = t_num / det >= +0.0 and its key orders as (t, id);
// a thread visits its triangles in ascending index (ascending tiles, each
// compacted list ascending) with a strict `<`, so the lowest index wins
// exact t ties, as the plain first-minimum argmin and strict cross-block
// merge do.  The window is part of the accept, so a ray with nothing
// accepted inside it keeps the seed key and decodes to idx 0, hit false.

#include "select_common.cuh"

namespace {

using srt::kBig;

constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 128;     // triangles staged per step
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 4;      // float4 words a table row
constexpr int kWidth = 3;      // rays a thread

// A 16-byte word of shared memory at a 32-bit shared address (one held in a
// register, so the compiler does not rebuild it from the block's window on
// every step).
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// x with its sign bit flipped where `by` has one: x * sgn(by) whenever by is
// neither zero nor NaN.
__device__ __forceinline__ float flip_sign(float x, float by) {
  return __int_as_float(__float_as_int(x) ^
                        (__float_as_int(by) & 0x80000000));
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
fast_select_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ center,  // (3,)
                   const float* __restrict__ tmax,    // (n_rays,) or null
                   const float4* __restrict__ pack,   // (T padded, 4) float4
                   const unsigned char* __restrict__ mask,  // (T,) or null
                   int n_rays, int n_tris, int split, float eps, int any_hit,
                   unsigned long long* __restrict__ keys) {  // (n_rays,)
  static_assert(kTile == 32 * kWarps, "a warp compacts a 32-triangle chunk");
  __shared__ float4 s_raw[2][kWords * kTile];  // tiles as copied
  __shared__ float4 s_tab[kWords * kTile];     // this tile's live rows
  __shared__ unsigned short s_id[kTile];       // their offsets in the tile

  // This block's share of the tiles: an even split, so no block is idle
  // while split <= n_tiles.
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  const int first = static_cast<int>(
      static_cast<long long>(blockIdx.y) * n_tiles / split);
  const int last = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * n_tiles / split);
  if (first >= last) return;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kThreads + threadIdx.x) * kWidth;
  // The loop keeps d and c = o x d of its rays in registers, nothing else
  // of them: the rare branch reloads the origin and the window and
  // recomputes det and u_num (the same operations, the same bits), so
  // that more blocks fit on an SM.
  float dx[kWidth], dy[kWidth], dz[kWidth];
  float cx[kWidth], cy[kWidth], cz[kWidth], best_t[kWidth];
  unsigned best_i[kWidth];
  // Bit j: ray r0 + j exists and (any-hit) is not decided yet.  Threads
  // past n_rays hold no bit and never touch `keys`.
  unsigned todo = 0;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const int r = r0 + j;
    float ox = 0.f, oy = 0.f, oz = 0.f;
    dx[j] = dy[j] = 0.f;
    dz[j] = 1.f;
    if (r < n_rays) {
      todo |= 1u << j;
      ox = o[3 * r] - center[0];
      oy = o[3 * r + 1] - center[1];
      oz = o[3 * r + 2] - center[2];
      dx[j] = d[3 * r];
      dy[j] = d[3 * r + 1];
      dz[j] = d[3 * r + 2];
    }
    // c = o x d in models/scene.py::cross3's order.
    cx[j] = oy * dz[j] - oz * dy[j];
    cy[j] = oz * dx[j] - ox * dz[j];
    cz[j] = ox * dy[j] - oy * dx[j];
    best_t[j] = kBig;
    best_i[j] = srt::kIMax;
  }

  auto stage = [&](int tile, int buf) {
    const float4* src = pack + static_cast<size_t>(tile) * (kWords * kTile);
    for (int k = threadIdx.x; k < kWords * kTile; k += kThreads)
      srt::cp_async16(&s_raw[buf][k], src + k);
    srt::cp_async_commit();
  };
  // Every warp holds the live flags of the whole tile: lane `lane` those
  // of its triangles 32 i + lane.
  bool live[kWarps];
  auto live_of = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int l = tile * kTile + 32 * i + lane;
      live[i] = l < n_tris && (mask == nullptr || mask[l] != 0);
    }
  };

  stage(first, 0);
  live_of(first);
  int buf = 0;
  for (int tile = first; tile < last; ++tile, buf ^= 1) {
    srt::cp_async_wait<0>();
    // The barrier publishes this tile, and frees the other buffer and the
    // compacted rows (read by the previous step) for overwriting.
    if (any_hit) {
#pragma unroll
      for (int j = 0; j < kWidth; ++j)
        if ((todo >> j & 1u) && srt::load_key(keys + r0 + j) == 0ull)
          todo &= ~(1u << j);
      if (__syncthreads_and(todo == 0u)) break;
    } else {
      __syncthreads();
    }
    if (tile + 1 < last) stage(tile + 1, buf ^ 1);

    // Compact the tile's live rows, ascending: every warp counts every
    // chunk, and warp w copies the rows of chunk w to their places.
    int count = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const unsigned b = __ballot_sync(0xffffffffu, live[i]);
      if (i == warp && live[i]) {
        const int pos = count + __popc(b & ((1u << lane) - 1u));
        const int l = 32 * i + lane;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          s_tab[kWords * pos + w] = s_raw[buf][kWords * l + w];
        s_id[pos] = static_cast<unsigned short>(l);
      }
      count += __popc(b);
    }
    // A zero row after an odd count: det = -0 fails the cull test for
    // every ray, so the loop can take two rows a step.
    if (threadIdx.x == 0 && (count & 1))
      s_tab[kWords * count] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile + 1 < last) live_of(tile + 1);
    __syncthreads();
    if (!__any_sync(0xffffffffu, todo != 0u)) continue;

    // Whether any of this thread's pairs with the row (q0, q1, q2) passes
    // the cull and u tests.
    auto passes = [&](const float4& q0, const float4& q1, const float4& q2) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < kWidth; ++j) {
        const float det = -(dx[j] * q0.x + dy[j] * q0.y + dz[j] * q0.z);
        const float u_num = cx[j] * q1.x + cy[j] * q1.y + cz[j] * q1.z +
                            dx[j] * q1.w + dy[j] * q2.x + dz[j] * q2.y;
        // Culled, a passing det is > eps >= 0: sgn is +1.
        const float adet = kCull ? det : fabsf(det);
        const float us = kCull ? u_num : flip_sign(u_num, det);
        any = any | ((kCull ? det > eps : adet > eps) & (us >= 0.f) &
                     (us <= adet));
      }
      return any;
    };
    // Rare: some pair with compacted row k (at shared address `row`) passed
    // the u test.  The plain arithmetic as written.
    const unsigned base = static_cast<unsigned>(tile) * kTile;
    auto accept = [&](int k, const float4& q0, const float4& q1,
                      const float4& q2, unsigned row) {
      const float4 q3 = lds128(row + 48);  // wv.z, e1
      const unsigned id = base + s_id[k];
#pragma unroll
      for (int j = 0; j < kWidth; ++j) {
        if (!(todo >> j & 1u)) continue;
        const float det = -(dx[j] * q0.x + dy[j] * q0.y + dz[j] * q0.z);
        const float u_num = cx[j] * q1.x + cy[j] * q1.y + cz[j] * q1.z +
                            dx[j] * q1.w + dy[j] * q2.x + dz[j] * q2.y;
        const float sgn = det >= 0.f ? 1.f : -1.f;
        const float adet = det * sgn;
        const float us = u_num * sgn;
        if (!((kCull ? det > eps : adet > eps) && us >= 0.f && us <= adet))
          continue;
        const float v_num = dx[j] * q2.z + dy[j] * q2.w + dz[j] * q3.x -
                            (cx[j] * q3.y + cy[j] * q3.z + cz[j] * q3.w);
        const float vs = v_num * sgn;
        if (!(vs >= 0.f && us + vs <= adet)) continue;
        const int r = r0 + j;
        const float t_num = (__ldg(o + 3 * r) - __ldg(center)) * q0.x +
                            (__ldg(o + 3 * r + 1) - __ldg(center + 1)) * q0.y +
                            (__ldg(o + 3 * r + 2) - __ldg(center + 2)) * q0.z -
                            q0.w;
        const float ts = t_num * sgn;
        if (!(ts > eps * adet)) continue;
        // The window, inclusive.
        if (tmax != nullptr && !(ts <= __ldg(tmax + r) * adet)) continue;
        if (any_hit) {
          todo &= ~(1u << j);
          atomicMin(keys + r, 0ull);
          continue;
        }
        const float t = t_num / det;
        if (t < best_t[j]) {
          best_t[j] = t;
          best_i[j] = id;
        }
      }
    };

    // Two rows a step: their loads and tests are independent work, and
    // one vote a step keeps the rare branch warp-uniform.
    unsigned row = static_cast<unsigned>(__cvta_generic_to_shared(s_tab));
    for (int k = 0; k < count; k += 2, row += 2 * kWords * 16) {
      const float4 a0 = lds128(row), a1 = lds128(row + 16),
                   a2 = lds128(row + 32);
      const float4 b0 = lds128(row + 64), b1 = lds128(row + 80),
                   b2 = lds128(row + 96);
      const bool pass_a = passes(a0, a1, a2);
      const bool pass_b = passes(b0, b1, b2);
      if (!__any_sync(0xffffffffu, pass_a | pass_b)) continue;
      if (__any_sync(0xffffffffu, pass_a)) accept(k, a0, a1, a2, row);
      if (__any_sync(0xffffffffu, pass_b))
        accept(k + 1, b0, b1, b2, row + 64);
    }
  }

  if (!any_hit) {
#pragma unroll
    for (int j = 0; j < kWidth; ++j)
      if ((todo >> j & 1u) && best_i[j] != srt::kIMax)
        atomicMin(keys + r0 + j, srt::pack_key(best_t[j], best_i[j]));
  }
}

template <bool kCull>
int launch(const float* o, const float* d, const float* center,
           const float* tmax, const float4* pack, const unsigned char* mask,
           int n_rays, int n_tris, int split, float eps, int any_hit,
           unsigned long long* keys, cudaStream_t stream) {
  const int block_rays = kThreads * kWidth;
  const dim3 grid((n_rays + block_rays - 1) / block_rays, split);
  fast_select_kernel<kCull><<<grid, kThreads, 0, stream>>>(
      o, d, center, tmax, pack, mask, n_rays, n_tris, split, eps, any_hit,
      keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches ceil(n_rays / (128 * 3)) x `split` blocks of 128 threads on
// `stream`, each thread holding 3 rays and each block an even share of the
// 128-triangle tiles, merging into the keys seeded with (BIG, IMAX).
// `pack` is the (T padded to 128, 16) table, 16-byte aligned; `tmax` (the
// window) and `mask` (one byte a triangle, 0 = skip) may be null.  Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int srt_fast_select(const void* o, const void* d,
                               const void* center, const void* tmax,
                               const void* pack, const void* mask,
                               int n_rays, int n_tris, int split, float eps,
                               int cull, int any_hit, void* keys,
                               void* stream) {
  const auto* fo = static_cast<const float*>(o);
  const auto* fd = static_cast<const float*>(d);
  const auto* fc = static_cast<const float*>(center);
  const auto* ft = static_cast<const float*>(tmax);
  const auto* fp = static_cast<const float4*>(pack);
  const auto* fm = static_cast<const unsigned char*>(mask);
  auto* k = static_cast<unsigned long long*>(keys);
  const auto s = static_cast<cudaStream_t>(stream);
  return cull ? launch<true>(fo, fd, fc, ft, fp, fm, n_rays, n_tris, split,
                             eps, any_hit, k, s)
              : launch<false>(fo, fd, fc, ft, fp, fm, n_rays, n_tris, split,
                              eps, any_hit, k, s);
}
