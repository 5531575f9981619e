// The backward of a row gather `table[idx]` for Hopper (sm_90a):
// out[r] = sum over the entries i with idx[i] == r of grad[i], every row of
// `width` values, deterministic and parallel over duplicates.
//
// Replaces no TPU kernel: the JAX package leaves the gathers' transpose (a
// scatter-add) to XLA.  PyTorch's own backward of `table[idx]`
// (index_put_ with accumulate) sorts the indices and then gives each
// (distinct row, column) to one thread, which walks the row's duplicates
// one at a time: serial in the longest run of equal indices.  The train
// step's gathers have runs of tens of thousands (every missed slot reads
// triangle 0, every untextured material texture 0, and an atlas of one
// texel is one run of the whole wavefront), so that walk took nine tenths
// of the step.
//
// What bounds it: bytes.  The work is one add an entry and column against
// the entry's grad row read (4 or 8 bytes a value), its sorted row id and
// position, and one partial written and read back a segment; at the train
// step's sizes (65,536 entries of at most 9 values) that is a few MB, a
// couple of microseconds at 3.35 TB/s, so launch latency and the sort
// around the kernel set the time.
//
// Design.  The wrapper (ops/gather.py) sorts the indices stably (torch.sort)
// and passes the sorted rows and the permutation.  Pass 1 cuts the sorted
// sequence into pieces of kPiece entries, one block a piece and one thread
// an entry, and runs a segmented inclusive scan (Hillis-Steele: at offset
// o = 1, 2, ..., kPiece / 2 an entry adds the value o places before it when
// both carry the same row, which, the rows being sorted, means the whole
// stretch between them does), in shared memory between two buffers, one
// barrier a step, on up to kCols columns at a time.  The last entry of each
// segment in the piece writes its sum, the piece's partial for that row, at
// its own sorted position.  Pass 2 gives each row a warp: two binary
// searches find the row's sorted range [lo, hi); a row in one piece takes
// its partial as it is; a row over several pieces has lane l add the
// partials of pieces l, l + 32, ... in piece order, then the lanes fold by a
// shuffle tree (offsets 16, 8, 4, 2, 1).  No thread walks more than kPiece
// duplicates in pass 1 or ceil(pieces / 32) partials in pass 2, there are
// no atomics, and the order of every add is fixed by the shapes: the same
// input gives the same bits on every run.  The plain version
// (ops/gather.py::row_sums_reference) makes the same adds in the same
// order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPiece = 256;       // sorted entries a block of pass 1 reduces
constexpr int kCols = 9;          // columns a step of pass 1 carries (the
                                  // widest gather: 9, vertex normals)
constexpr int kRowsPerBlock = 8;  // pass 2: one warp a row
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kPiece)
piece_sums_kernel(const int64_t* __restrict__ rows,  // (n,) sorted
                  const int64_t* __restrict__ perm,  // (n,) entry of a slot
                  const T* __restrict__ grad,        // (entries, width)
                  int64_t n, int width,
                  T* __restrict__ partial) {         // (n, width)
  __shared__ int64_t s_row[kPiece];
  __shared__ T s_a[kPiece * kCols], s_b[kPiece * kCols];

  const int t = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPiece + t;
  const bool valid = i < n;
  const int64_t row = valid ? rows[i] : -1;
  s_row[t] = row;
  __syncthreads();
  // Bit k: the entry 2^k places before this one lies in the piece and
  // carries the same row.  Invalid entries sit at the piece's tail, after
  // every valid one, and never write.
  unsigned same = 0;
  for (int k = 0, o = 1; o < kPiece; ++k, o <<= 1)
    if (t >= o && s_row[t - o] == row) same |= 1u << k;
  const bool last = valid && (t == kPiece - 1 || i + 1 == n ||
                              s_row[t + 1] != row);
  const int64_t src = valid ? perm[i] * width : 0;

  // The scan runs on kCols columns at a time, between two buffers: step k
  // reads one and writes the other, so one barrier a step keeps it exact.
  for (int c0 = 0; c0 < width; c0 += kCols) {
    const int g = width - c0 < kCols ? width - c0 : kCols;
    T* cur = s_a;
    T* nxt = s_b;
    __syncthreads();  // the previous columns' last reads are done
    for (int j = 0; j < g; ++j)
      cur[t * kCols + j] = valid ? grad[src + c0 + j] : T(0);
    for (int k = 0, o = 1; o < kPiece; ++k, o <<= 1) {
      __syncthreads();
      const bool add = (same >> k) & 1u;
      for (int j = 0; j < g; ++j) {
        T v = cur[t * kCols + j];
        if (add) v += cur[(t - o) * kCols + j];
        nxt[t * kCols + j] = v;
      }
      T* swap = cur;
      cur = nxt;
      nxt = swap;
    }
    if (last)
      for (int j = 0; j < g; ++j)
        partial[i * width + c0 + j] = cur[t * kCols + j];
  }
}

// First sorted position whose row is >= r.
__device__ __forceinline__ int64_t lower_bound(const int64_t* rows, int64_t n,
                                               int64_t r) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (rows[mid] < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_sums_kernel(const int64_t* __restrict__ rows, const T* __restrict__ partial,
                int64_t n, int width, int64_t n_rows,
                T* __restrict__ out) {  // (n_rows, width)
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // whole warps leave together
  const int64_t lo = lower_bound(rows, n, r);
  const int64_t hi = lower_bound(rows, n, r + 1);
  T* dst = out + r * width;
  if (lo == hi) {
    for (int c = lane; c < width; c += 32) dst[c] = T(0);
    return;
  }
  const int64_t p0 = lo / kPiece, p1 = (hi - 1) / kPiece;
  if (p0 == p1) {  // one piece: its partial is the row's sum
    for (int c = lane; c < width; c += 32)
      dst[c] = partial[(hi - 1) * width + c];
    return;
  }
  for (int c = 0; c < width; ++c) {
    T acc = T(0);
    for (int64_t p = p0 + lane; p <= p1; p += 32) {
      const int64_t end = (p + 1) * kPiece < hi ? (p + 1) * kPiece : hi;
      acc += partial[(end - 1) * width + c];
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
    if (lane == 0) dst[c] = acc;
  }
}

template <typename T>
int launch(const void* rows, const void* perm, const void* grad, int64_t n,
           int width, int64_t n_rows, void* partial, void* out,
           cudaStream_t stream) {
  const auto* r = static_cast<const int64_t*>(rows);
  const auto pieces = static_cast<unsigned>((n + kPiece - 1) / kPiece);
  const auto warps =
      static_cast<unsigned>((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  piece_sums_kernel<T><<<pieces, kPiece, 0, stream>>>(
      r, static_cast<const int64_t*>(perm), static_cast<const T*>(grad), n,
      width, static_cast<T*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_sums_kernel<T><<<warps, 32 * kRowsPerBlock, 0, stream>>>(
      r, static_cast<const T*>(partial), n, width, n_rows,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1 over ceil(n / 256) blocks of 256 threads, then pass 2 over
// ceil(n_rows / 8) blocks of 8 warps, on `stream`.  rows, perm: int64 (n,),
// the sorted row ids and the entry each sorted slot came from; grad: the
// gathered rows' gradient (entries, width), float32 or float64
// (`is_double`); partial: scratch of (n, width); out: (n_rows, width), every
// value written.  Needs n >= 1 and width >= 1.  Returns the cudaError_t of
// the first launch that failed (0 = ok).
extern "C" int srt_gather_grad(const void* rows, const void* perm,
                               const void* grad, long long n, int width,
                               long long n_rows, int is_double, void* partial,
                               void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(rows, perm, grad, n, width, n_rows, partial,
                              out, s)
             : launch<float>(rows, perm, grad, n, width, n_rows, partial, out,
                             s);
}
