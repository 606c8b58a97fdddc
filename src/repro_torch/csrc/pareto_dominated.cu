// pareto_dominated: eps-band Pareto dominance verdicts on Hopper.
//
// Replaces the XLA kernels of the JAX package's frontier masks:
//   repro/core/pareto.py:chunk_dominated, chunked over every row by
//     repro/core/batched.py:pareto_mask                          (A2)
//   repro/core/pareto.py:_sharded_fns / nondominated_mask_sharded, its
//     per-block prefilter (phase 1) and its refinement (phase 2)  (A3)
// None of them is a Pallas kernel: XLA fused the comparisons of one chunk
// into a (chunk, n) mask and reduced it.  The port's plain version is
// core/pareto.py:dominated_ref (chunk_dominated per chunk or block).
//
// What it computes: for candidates (c, k) and rows (n, k), float64,
// dominated[i] is true iff some row r has, for every objective d,
//   r[d] <= cands[i, d] + eps   and, for some d,   r[d] < cands[i, d] - eps.
// With seg > 0 candidate i is tested only against the rows of its own
// block [i / seg * seg, i / seg * seg + seg) (A3's phase 1, where rows and
// candidates are the same array); with seg = 0 against every row.
//
// Exactness.  Each bound cands[i, d] +- eps is computed once, in float64
// round-to-nearest (__dadd_rn / __dsub_rn), as torch's blk + eps is, and
// compared with <= and < as written: a NaN on either side makes both
// comparisons false, as it does in the plain version, so no comparison is
// negated.  A +inf pad row dominates no finite candidate.  The verdict is
// an any() over rows, so the order in which rows are scanned, and where
// the scan stops, cannot change it: the booleans equal the plain
// version's.
//
// Design.  One thread per candidate holds its 2k bounds in registers.  A
// block of kThreads candidates streams the rows it needs through shared
// memory in tiles of kTileRows rows, double-buffered with cp.async (8-byte
// copies, so any row offset is aligned): the next tile is in flight while
// the block tests the current one.  Every thread of a block reads the
// same row of the tile at the same time, a shared-memory broadcast.  A
// thread whose candidate is dominated skips the tests of later tiles, so
// a warp whose candidates are all dominated costs nothing but the loads,
// and the block stops once every candidate in it is dominated
// (__syncthreads_and).  Most lattice points are dominated within the
// first tiles; frontier members scan every row.  One launch covers a
// whole frontier and keeps no (c, n) mask in device memory.  In seg mode a
// block's candidates may span several blocks of rows: the block streams
// the union of their rows and each thread tests only its own.
//
// Bound on the H100 SXM: two float64 comparisons per objective per pair
// tested, at 64 FP64 lanes per SM, against the objectives read once and
// the verdicts written once: operations bound it at lattice scale.  Early
// exit takes the pairs tested below the all-pairs count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 256;
constexpr int kMaxObjectives = 8;

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [lo, hi) of `rows` into `tile`, each thread a strided share of the
// (hi - lo) * K doubles, as one cp.async group.
template <int K>
__device__ __forceinline__ void load_tile(double* tile, const double* rows,
                                          int64_t lo, int64_t hi) {
  const int64_t count = (hi - lo) * K;
  const double* src = rows + lo * K;
  for (int64_t e = threadIdx.x; e < count; e += kThreads)
    cp_async8(tile + e, src + e);
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    dominated_kernel(const double* __restrict__ rows, int64_t n,
                     const double* __restrict__ cands, int64_t c, double eps,
                     int64_t seg, bool* __restrict__ out) {
  __shared__ __align__(16) double tiles[2][kTileRows * K];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = first + threadIdx.x;
  const bool active = i < c;
  const int64_t last = min(first + kThreads, c) - 1;

  // this thread's rows, and the union of the block's
  int64_t lo = 0, hi = n, block_lo = 0, block_hi = n;
  if (seg > 0) {
    const int64_t mine = active ? i : last;
    lo = mine / seg * seg;
    hi = min(lo + seg, n);
    block_lo = first / seg * seg;
    block_hi = min(last / seg * seg + seg, n);
  }

  double upper[K], lower[K];
#pragma unroll
  for (int d = 0; d < K; ++d) {
    const double v = active ? cands[i * K + d] : 0.0;
    upper[d] = __dadd_rn(v, eps);
    lower[d] = __dsub_rn(v, eps);
  }

  bool dominated = false;
  const int64_t tiles_needed =
      block_hi > block_lo ? (block_hi - block_lo + kTileRows - 1) / kTileRows
                          : 0;
  if (tiles_needed > 0)
    load_tile<K>(tiles[0], rows, block_lo,
                 min(block_lo + kTileRows, block_hi));
  for (int64_t t = 0; t < tiles_needed; ++t) {
    const int64_t t_lo = block_lo + t * kTileRows;
    const int64_t t_hi = min(t_lo + kTileRows, block_hi);
    if (t + 1 < tiles_needed)
      load_tile<K>(tiles[(t + 1) & 1], rows, t_hi,
                   min(t_hi + kTileRows, block_hi));
    else
      cp_async_commit();                 // an empty group keeps the count
    cp_async_wait<1>();                  // this thread's copies of tile t
    __syncthreads();                     // everyone's copies of tile t
    if (active && !dominated) {
      const double* tile = tiles[t & 1];
      const int r_lo = static_cast<int>(max(lo, t_lo) - t_lo);
      const int r_hi = static_cast<int>(max(min(hi, t_hi), t_lo) - t_lo);
      for (int r = r_lo; r < r_hi; ++r) {
        bool le = true, lt = false;
#pragma unroll
        for (int d = 0; d < K; ++d) {
          const double v = tile[r * K + d];
          le = le && (v <= upper[d]);
          lt = lt || (v < lower[d]);
        }
        dominated = dominated || (le && lt);
      }
    }
    // every thread is done with tile t before tile t + 2 overwrites it
    if (__syncthreads_and(dominated || !active)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (active) out[i] = dominated;
}

template <int K>
cudaError_t launch(const double* rows, int64_t n, const double* cands,
                   int64_t c, double eps, int64_t seg, bool* out,
                   cudaStream_t stream) {
  const int64_t blocks = (c + kThreads - 1) / kThreads;
  dominated_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(rows, n, cands, c, eps, seg, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest objective count k the kernel takes.
int pareto_dominated_max_objectives() { return kMaxObjectives; }

// dominated (c,) bool for candidates (c, k) against rows (n, k), float64,
// contiguous, on the device; seg > 0 tests candidate i only against rows
// [i / seg * seg, i / seg * seg + seg).  Launches one kernel on `stream`
// and returns its CUDA error code (0 on success; cudaErrorInvalidValue for
// k outside 1..kMaxObjectives, a negative count or more than 2^31 - 1
// blocks).
int pareto_dominated(const double* rows, int64_t n, const double* cands,
                     int64_t c, int k, double eps, int64_t seg, bool* out,
                     cudaStream_t stream) {
  if (n < 0 || c < 0 || seg < 0 ||
      (c + kThreads - 1) / kThreads > INT32_MAX)
    return cudaErrorInvalidValue;
  if (c == 0) return cudaSuccess;
  switch (k) {
    case 1: return launch<1>(rows, n, cands, c, eps, seg, out, stream);
    case 2: return launch<2>(rows, n, cands, c, eps, seg, out, stream);
    case 3: return launch<3>(rows, n, cands, c, eps, seg, out, stream);
    case 4: return launch<4>(rows, n, cands, c, eps, seg, out, stream);
    case 5: return launch<5>(rows, n, cands, c, eps, seg, out, stream);
    case 6: return launch<6>(rows, n, cands, c, eps, seg, out, stream);
    case 7: return launch<7>(rows, n, cands, c, eps, seg, out, stream);
    case 8: return launch<8>(rows, n, cands, c, eps, seg, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

const char* pareto_dominated_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
