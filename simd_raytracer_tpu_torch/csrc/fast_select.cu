// Division-free bilinear select ("fast") for Hopper (sm_90a).
//
// Replaces simd_raytracer_tpu/ops/intersect_mxu.py `mt_select_fast`, jnp code
// that XLA compiles into one fusion on the TPU (no Pallas kernel).  Every
// Moller-Trumbore numerator is a scalar triple product, bilinear in per-ray
// features (the centred origin o, d and c = o x d) and per-triangle
// constants (n = e1 x e2, v0 . n, wu = v0 x e2, wv = e1 x v0, e1, e2, with
// v0 centred on the mean of v0).  The wrapper (ops/intersect_fast.py) builds
// those constants once per frame as a (16, T) SoA table with the torch ops
// of the plain version; the kernel forms the four numerators, runs the
// accept tests on them with no division (signs folded in by sgn(det), the
// optional window as t_num * s <= t_max * |det|) and divides once, t_num /
// det, for an accepted pair's sort key.
//
// What bounds it: arithmetic.  A pair costs 9 float operations up to the
// cull test and 49 if it reaches the window test (41 additions and
// multiplications, 8 comparisons; chip_smoke.py::FAST_STAGE_OPS counts
// each test's share), against 64 bytes of triangle constants that the
// block's 128 rays reuse from shared memory.  The layout is K1's (csrc/mt_select.cu): 128 rays a block, one a
// thread, 256-triangle tiles staged as SoA rows (every thread reads the
// same word per step: a broadcast), the tile range split over gridDim.y by
// ops/intersect_brute.py::k1_split when the ray blocks alone would not fill
// the card, winners merged with a 64-bit atomicMin on the packed (t, id)
// keys of select_common.cuh; any-hit rays publish key 0 and blocks poll the
// keys at each tile boundary.
//
// Exactness: winners equal the plain torch version (one op per arithmetic
// step, left to right as Python adds), so the library is built with
// --fmad=false and IEEE division.  An accepted pair has t_num * s > eps *
// |det| >= 0, so t = t_num / det >= +0.0 and its key orders as (t, id);
// lanes run in ascending triangle index with a strict `<`, so the lowest
// index wins exact t ties, as the plain first-minimum argmin and strict
// cross-block merge do.  Unlike K1 the window is part of the accept, so a
// ray with nothing accepted inside it keeps the seed key and decodes to
// idx 0, hit false.

#include "select_common.cuh"

namespace {

using srt::kBig;

constexpr int kRays = 128;  // rays per block
constexpr int kTile = 256;  // triangles staged per step
// Table rows: n (3), v0 . n, wu (3), wv (3), e1 (3), e2 (3).
constexpr int kRows = 16;

__global__ void __launch_bounds__(kRays)
fast_select_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ center,  // (3,)
                   const float* __restrict__ tmax,    // (n_rays,) if windowed
                   const float* __restrict__ table,   // (16, n_tris) SoA
                   const int* __restrict__ mask,      // (n_tris,) 0 = skip
                   int n_rays, int n_tris, int tiles_per_block, float eps,
                   int cull, int any_hit, int windowed,
                   unsigned long long* __restrict__ keys) {  // (n_rays,)
  __shared__ float s_tab[kRows * kTile];
  __shared__ int s_mask[kTile];

  const int r = blockIdx.x * kRays + threadIdx.x;
  const bool active = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f, tm = 0.f;
  if (active) {
    ox = o[3 * r] - center[0];
    oy = o[3 * r + 1] - center[1];
    oz = o[3 * r + 2] - center[2];
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    if (windowed) tm = tmax[r];
  }
  // c = o x d in models/scene.py::cross3's order.
  const float cx = oy * dz - oz * dy;
  const float cy = oz * dx - ox * dz;
  const float cz = ox * dy - oy * dx;
  float best_t = kBig;
  unsigned best_i = srt::kIMax;
  // Any-hit: a ray is done once found (here or, per its key, elsewhere).
  // Threads past n_rays are done from the start and never touch `keys`.
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
    for (int k = threadIdx.x; k < kRows * kTile; k += kRays) {
      const int row = k / kTile, col = k % kTile;
      s_tab[k] = col < n
                     ? table[static_cast<size_t>(row) * n_tris + base + col]
                     : 0.f;
    }
    for (int k = threadIdx.x; k < kTile; k += kRays) {
      s_mask[k] = k < n ? mask[base + k] : 0;
    }
    __syncthreads();
    if (done) continue;

    for (int l = 0; l < n; ++l) {
      if (s_mask[l] <= 0) continue;
      const float* q = s_tab + l;  // row k of triangle l at q[k * kTile]
      const float nx = q[0], ny = q[kTile], nz = q[2 * kTile];
      const float det = -(dx * nx + dy * ny + dz * nz);
      const float sgn = det >= 0.f ? 1.f : -1.f;
      const float adet = det * sgn;
      if (!(cull ? det > eps : adet > eps)) continue;
      const float u_num = cx * q[13 * kTile] + cy * q[14 * kTile] +
                          cz * q[15 * kTile] + dx * q[4 * kTile] +
                          dy * q[5 * kTile] + dz * q[6 * kTile];
      const float us = u_num * sgn;
      if (!(us >= 0.f && us <= adet)) continue;
      const float v_num =
          dx * q[7 * kTile] + dy * q[8 * kTile] + dz * q[9 * kTile] -
          (cx * q[10 * kTile] + cy * q[11 * kTile] + cz * q[12 * kTile]);
      const float vs = v_num * sgn;
      if (!(vs >= 0.f && us + vs <= adet)) continue;
      const float t_num = ox * nx + oy * ny + oz * nz - q[3 * kTile];
      const float ts = t_num * sgn;
      if (!(ts > eps * adet)) continue;
      if (windowed && !(ts <= tm * adet)) continue;  // inclusive window
      if (any_hit) {
        done = true;
        atomicMin(keys + r, 0ull);
        break;
      }
      const float t = t_num / det;
      if (t < best_t) {
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
// each block taking a share of the triangle tiles, merging into the keys
// seeded with (BIG, IMAX); `tmax` is read only when `windowed`.  Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int srt_fast_select(const void* o, const void* d,
                               const void* center, const void* tmax,
                               const void* table, const void* mask,
                               int n_rays, int n_tris, int split, float eps,
                               int cull, int any_hit, int windowed,
                               void* keys, void* stream) {
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  const dim3 grid((n_rays + kRays - 1) / kRays, split);
  fast_select_kernel<<<grid, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(center), static_cast<const float*>(tmax),
      static_cast<const float*>(table), static_cast<const int*>(mask), n_rays,
      n_tris, (n_tiles + split - 1) / split, eps, cull, any_hit, windowed,
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}
