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
// Exactness.  Each bound cands[i, d] +- eps is computed in float64
// round-to-nearest (__dadd_rn / __dsub_rn), as torch's blk + eps is, and
// compared with <= and < as written: a NaN on either side makes both
// comparisons false, as it does in the plain version, so no comparison is
// negated.  A +inf pad row dominates no finite candidate.  The verdict is
// an any() over rows, so the order in which rows are tested, how they are
// split among threads and blocks, and where a test stops, cannot change
// it, as long as every row of a candidate's test is tested before the
// candidate is declared not dominated: the booleans equal the plain
// version's.
//
// Design, for 1 to kMaxObjectives objectives: two passes, launched back
// to back on one stream with no host round trip between them.  Both
// compare through a float32 prefilter: a row x can dominate only if, for
// every d, x[d] rounded down to float32 is <= upper[d] rounded up (x <=
// upper implies it, a NaN fails it), so only the rows that pass are
// tested in float64, where the verdict is made; the float64 comparisons
// run at a fraction of the card's FP64 rate.  All
// comparisons combine with & and |, never && and ||, which would put a
// branch and a load between every two.
//
// 1. Screen (screen_kernel): each candidate against at most kScreenRows
//    rows, a stream staged in shared memory (float64 and rounded,
//    16-byte rows):
//      - a test of at most kScreenRows rows (n <= kScreenRows, or a seg
//        block no longer) is tested whole and decided here: A3's phase 1
//        at its default block of at most 1,024;
//      - with seg = 0 and n > kScreenRows, the rows q * (n / kScreenRows)
//        for q < kScreenRows, a sample spread over the whole array: on the
//        lattice frontiers a few rows dominate almost every point, and a
//        spread sample meets one of them far sooner than the first rows do
//        (the rows are in lattice order);
//      - with seg > kScreenRows, the first kScreenRows rows of the block.
//    With seg = 0 all candidates share the stream, which every block of a
//    persistent grid stages once; with seg > 0 a slab is up to kSegSlab
//    candidates of one block of rows.  Each lane tests one candidate,
//    kStep rows a step (independent loads and comparisons), until a row
//    dominates it or its rows end, and its warp then hands it the next
//    candidate of a queue: lanes do not wait for one another's scans.
//    Once the queue is empty, the warp takes its open candidates one at a
//    time, its lanes striding the rest of each one's rows (screen_tail):
//    no candidate's scan of its 1,024 rows stays serial on one lane.
//    The screen writes every verdict.  A candidate it leaves undecided
//    (not dominated, its test not whole) is appended to a survivor list
//    in device scratch (one atomicAdd per warp, per candidate in the
//    tail).
// 2. Split (split_kernel), launched only where some test is longer than
//    kScreenRows: each survivor against every row of its test, the rows
//    spread over the whole card.  A persistent grid reads the survivor
//    count on the device and takes work items from a device counter until
//    they are used up.  An item is a slab of 32 to 256 survivors (fewer
//    where there are few) and a partition of the rows; the slab size and
//    the partition count are chosen on the device so that the items fill
//    the grid about kWaves times: an item taken in a later wave finds the
//    done flags that earlier ones set, and skips the survivors they
//    decided.  A block walks its partition
//    in chunks of chunk_rows<K>() rows, double-buffered: a 1-D TMA bulk
//    copy (cp.async.bulk completing on an mbarrier) where the chunk's
//    start and size are 16-byte aligned, 8-byte cp.async otherwise (a row
//    is k * 8 bytes, so a chunk's start is not always 16-byte aligned).
//    At each chunk the block compacts its live survivors into groups of
//    kGroup and deals (group, slice of the chunk) units round its warps,
//    more slices where there are few groups; a unit's lanes stride its
//    rows, kLaneRows a lane a step, each row against every member of the
//    group (float32 bounds in registers), and combine with
//    __reduce_or_sync.  So a survivor nothing dominates costs a warp step
//    per 128 rows, spread over many blocks, not one thread per row.
//    A witness stores true into out[i] and sets the survivor's done
//    flag; every survivor rereads its flag (from L2) before each chunk.
//    A stale read of a flag costs work and never changes a verdict, and
//    two items that both store true store the same value, so the races
//    are harmless.
//
// 3. Wide, for more than kMaxObjectives objectives and for none: the same
//    two passes for an objective count known only at run time, one code
//    path for every count (two instantiations: rows staged in shared
//    memory up to kWideStage objectives, read in place above, their
//    bounds then computed again, to the same bits).  Rows are staged column
//    by column with 8-byte cp.async (a row is k * 8 bytes, so neither its
//    start nor a column is 16-byte aligned), so that consecutive lanes read
//    one column.  The work is units: a group of kWideGroup candidates
//    against a range of rows, a warp each, its lanes striding the rows
//    kWideLaneRows a lane a step (wide_unit).  A step tests `<=` over every
//    objective for all its (member, row) pairs, four objectives at a time
//    until none passes, then `<` for the few that passed; the lanes combine
//    with __reduce_or_sync.
//    - Wide screen (wide_screen_kernel): a block of kWideScreenWarps warps
//      takes slabs of candidates, stages their stream once, at most
//      wide_screen_rows(k) rows (the narrow screen's stream, shorter where
//      kWideScreenValues cannot hold kScreenRows), and its warps take the
//      slab's groups from a queue with no barrier between them, each group
//      against the whole stream.  A test no longer than the stream is
//      decided here (A3's phase 1).
//    - Wide split (wide_split_kernel): the split's persistent grid, items
//      of (slab of survivors, partition of the rows) and done flags; a
//      block walks its partition in chunks of wide_chunk_rows(k) rows,
//      double-buffered, and deals (group, slice of the chunk) units round
//      its warps (wide_walk).
//    No float32 prefilter: the `<=` pass is not bound by the float64
//    compares (PERF.md: a float32 compare in its place was slower).  With
//    k = 0 no row is read: no objective can be strictly better, so every
//    verdict is false, as the plain version's.
//
// Bound on the H100 SXM: two float64 comparisons per objective per pair
// tested, at 64 FP64 lanes per SM, against the objectives read once and
// the verdicts written once: operations bound it at lattice scale, and the
// pairs the data need are one witness per dominated candidate and every
// row for a candidate nothing dominates.  A single pass that gives each
// candidate one thread leaves the few that nothing dominates to walk every
// row alone (4.4 ms for the four scenario frontiers).  What bounds this
// one on the frontiers: the items of the split's first wave all start at
// once, so every survivor is tested against the first chunk of each of
// their partitions before the done flags can stop it (PERF.md gives the
// counts).  A single warp per candidate at wide k (the first wide kernel)
// left each point nothing dominates to walk every row as one chain of
// warp steps; the wide passes spread those scans as the narrow ones do.
// Of what is left, about two fifths is the floor of a call's launches and
// scratch (PERF.md gives the split).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScreenRows = 1024;        // screen: rows per candidate
constexpr int kMaxObjectives = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWaves = 4;                // split: items per resident block
constexpr int kWideStage = 64;           // wide: objectives staged
constexpr unsigned kFull = 0xffffffffu;

// split: rows per chunk (a buffer of at most 32 KB)
template <int K>
__host__ __device__ constexpr int chunk_rows() {
  return K <= 4 ? 1024 : 512;
}

// floats per row of a rounded buffer: a row is one or two 16-byte loads
template <int K>
__host__ __device__ constexpr int low_stride() {
  return K <= 4 ? 4 : 8;
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned `src` into 16-byte
// aligned shared `dst`, one TMA bulk copy counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// Whether row x dominates the candidate of bounds upper / lower: <= and <
// as written, so a NaN on either side never makes a witness.  The row is
// loaded whole and the comparisons combined with & and |, not && and ||:
// a short-circuit would put a branch, and a load behind it, between every
// two comparisons.
template <int K>
__device__ __forceinline__ bool dominates(const double* x,
                                          const double* upper,
                                          const double* lower) {
  double v[K];
#pragma unroll
  for (int d = 0; d < K; ++d) v[d] = x[d];
  bool le = true, lt = false;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    le &= v[d] <= upper[d];
    lt |= v[d] < lower[d];
  }
  return le & lt;
}

// The float32 prefilter: whether row x, rounded down to float32 (`low`),
// is <= the candidate's upper bounds rounded up (`up`) in every objective.
// x <= upper implies it, and a NaN fails it as it fails <=, so a row that
// fails it is no witness, and only the rows that pass are tested in
// float64, where the verdict is made.  (The float64 comparisons run at a
// fraction of the card's FP64 rate; the prefilter turns most of them
// away.)
template <int K>
__device__ __forceinline__ bool may_dominate(const float* low,
                                             const float* up) {
  float v[low_stride<K>()];
#pragma unroll
  for (int d = 0; d < low_stride<K>(); d += 4)
    *reinterpret_cast<float4*>(v + d) =
        *reinterpret_cast<const float4*>(low + d);
  bool pass = true;
#pragma unroll
  for (int d = 0; d < K; ++d) pass &= v[d] <= up[d];
  return pass;
}

// Rows a thread tests per step: their prefilters have no dependence on one
// another, so their loads and comparisons overlap.
constexpr int kStep = 16;

// The first row in [r0, r1) of a staged buffer (float64 `rows`, rounded
// `low`) that dominates the candidate of bounds upper / lower (`up`: upper
// rounded up to float32), or -1.  kStep rows a step, the prefilter first;
// no warp-wide operation, so the lanes of a warp may stop at different
// rows.
template <int K>
__device__ __forceinline__ int first_witness(const double* rows,
                                             const float* low, int r0,
                                             int r1, const float* up,
                                             const double* upper,
                                             const double* lower) {
  for (int r = r0; r < r1; r += kStep) {
    // every row of the step loaded and tested, the rows past r1 masked
    // (their loads clamped to row r1 - 1)
    unsigned pass = 0;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const bool ok =
          may_dominate<K>(low + min(r + j, r1 - 1) * low_stride<K>(), up);
      pass |= static_cast<unsigned>(ok & (r + j < r1)) << j;
    }
    for (; pass; pass &= pass - 1) {
      const int q = r + __ffs(pass) - 1;
      if (dominates<K>(rows + q * K, upper, lower)) return q;
    }
  }
  return -1;
}

// ---------------------------------------------------------------------------
// 1. screen
// ---------------------------------------------------------------------------

// The stream of rows every candidate of a slab is tested against (at most
// kScreenRows), in float64 and rounded down to float32, and the slab.
template <int K>
struct ScreenSmem {
  double rows[kScreenRows * K];
  float low[kScreenRows * low_stride<K>()];
  int queue;               // with seg > 0: the slab's next candidates
  int slab;                // with seg > 0: the slab
};

// With seg > 0, candidates per slab: the blocks of rows are cut into
// slabs of at most this many candidates, so that a few long blocks still
// spread over the card.
constexpr int kSegSlab = 256;
// Candidates a warp takes from the queue at once.
constexpr int kBatch = 32;

// Refill a warp's free lanes once at least this many are free; a lane
// tests at most kSlice rows of its candidate between two refills.
constexpr int kRefill = 8;
constexpr int kSlice = 4 * kStep;

// The screen's tail, once its queue is empty: the warp's open candidates
// (lane i >= 0, next row q, bounds upper / lower / up), one at a time, each
// against rows [q, len) of the staged stream with the warp's lanes striding
// them, kStep rows a lane a step, and the lanes' verdicts combined with
// __any_sync.  So a candidate nothing dominates costs the warp two steps
// for 1,024 rows, not one lane 64.  Writes each verdict and appends each
// candidate that is not dominated and whose test is not whole to the
// survivors.
template <int K>
__device__ __forceinline__ void screen_tail(
    const double* rows, const float* low, int len, bool whole, int64_t i,
    int q, const double* upper, const double* lower, const float* up,
    bool* out, int* survivors, int* count) {
  const int lane = threadIdx.x & 31;
  for (unsigned open = __ballot_sync(kFull, i >= 0); open;
       open &= open - 1) {
    const int src = __ffs(open) - 1;
    const int64_t ci = __shfl_sync(kFull, static_cast<long long>(i), src);
    const int r_lo = __shfl_sync(kFull, q, src);
    double cu[K], cl[K];
    float cup[K];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      cu[d] = __shfl_sync(kFull, upper[d], src);
      cl[d] = __shfl_sync(kFull, lower[d], src);
      cup[d] = __shfl_sync(kFull, up[d], src);
    }
    bool found = false;
    for (int r0 = r_lo; r0 < len && !found; r0 += 32 * kStep) {
      // row r0 + j * 32 + lane: the lanes read consecutive rows
      unsigned pass = 0;
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const int r = r0 + j * 32 + lane;
        const bool ok =
            may_dominate<K>(low + min(r, len - 1) * low_stride<K>(), cup);
        pass |= static_cast<unsigned>(ok & (r < len)) << j;
      }
      bool hit = false;
      for (; pass && !hit; pass &= pass - 1)
        hit = dominates<K>(rows + (r0 + (__ffs(pass) - 1) * 32 + lane) * K,
                           cu, cl);
      found = __any_sync(kFull, hit);
    }
    if (lane == src) out[ci] = found;
    if (!found && !whole && lane == 0)
      survivors[atomicAdd(count, 1)] = static_cast<int>(ci);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    screen_kernel(const double* __restrict__ rows, int64_t n,
                  const double* __restrict__ cands, int64_t c, double eps,
                  int64_t seg, bool* __restrict__ out,
                  int* __restrict__ survivors, int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScreenSmem<K>& sm = *reinterpret_cast<ScreenSmem<K>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  // With seg = 0 every candidate's stream is the same, all n rows or the
  // sample of kScreenRows spread over them: one slab, whose candidates all
  // the blocks take from count[2].  With seg > 0 a slab is up to kSegSlab
  // candidates of one block of rows, which share the stream of that
  // block's rows; the blocks take slabs from count[2], and the warps of a
  // block take the slab's candidates from sm.queue.
  const bool sampled = seg == 0 && n > kScreenRows;
  const int64_t stride = sampled ? n / kScreenRows : 1;
  const int64_t per_block = (seg + kSegSlab - 1) / kSegSlab;
  const int64_t slabs = seg > 0 ? (n + seg - 1) / seg * per_block : 1;
  // With seg = 0 a warp fills at most `lanes` lanes, its share of the
  // candidates, and takes them `lanes` at a time: a few hundred candidates
  // spread over every warp of the grid instead of filling a few.
  const int64_t warps = int64_t{gridDim.x} * kWarps;
  const int lanes = seg > 0 ? 32
                            : static_cast<int>(min(int64_t{32},
                                                   (c + warps - 1) / warps));
  const unsigned lane_mask = lanes == 32 ? kFull : (1u << lanes) - 1;
  const int take = min(kBatch, lanes), refill = min(kRefill, lanes);
  for (int64_t done_slabs = 0;; ++done_slabs) {
    if (seg == 0 && done_slabs > 0) break;
    int64_t first = 0, cand0 = 0;      // the stream's first row, candidate
    if (seg > 0) {
      __syncthreads();                 // the last slab is done with sm
      if (threadIdx.x == 0) {
        sm.slab = atomicAdd(count + 2, 1);
        sm.queue = 0;
      }
      __syncthreads();
      if (sm.slab >= slabs) break;
      first = sm.slab / per_block * seg;
      cand0 = first + sm.slab % per_block * kSegSlab;
    }
    const int64_t cands_here =
        seg > 0 ? max(int64_t{0}, min(min(int64_t{kSegSlab},
                                          first + seg - cand0), c - cand0))
                : c;
    const int64_t test = seg > 0 ? min(seg, n - first) : n;
    const int len = static_cast<int>(min(test, int64_t{kScreenRows}));
    const bool whole = test <= kScreenRows;
    int* queue = seg > 0 ? &sm.queue : count + 2;

    // the stream: row q is rows[first + q * stride], four loads in flight
    // per thread
    for (int e0 = threadIdx.x; e0 < len * K; e0 += 4 * kThreads) {
      double v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = min(e0 + u * kThreads, len * K - 1);
        v[u] = rows[(first + (e / K) * stride) * K + e % K];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e < len * K) {
          sm.rows[e] = v[u];
          sm.low[e / K * low_stride<K>() + e % K] = __double2float_rd(v[u]);
        }
      }
    }
    __syncthreads();

    // Each lane tests one candidate at a time, kSlice rows between two
    // looks at the warp, until a row dominates it or its rows end; a warp
    // refills its free lanes from the queue, `take` candidates a batch,
    // and appends its survivors with one atomic.  Once the queue is empty
    // (read while a slice runs, where a lane is free), the warp's open
    // candidates go to screen_tail.
    int64_t i = -1;                    // this lane's candidate
    int q = 0;                         // its next row
    double upper[K] = {}, lower[K] = {};
    float up[K] = {};
    int batch = 0, batch_end = 0;      // the warp's batch, uniform
    bool drained = false;              // the queue is empty, uniform
    for (;;) {
      unsigned free = __ballot_sync(kFull, i < 0) & lane_mask;
      if (!drained && (__popc(free) >= refill || free == lane_mask)) {
        while (free) {
          if (batch == batch_end) {
            int got = 0;
            if (lane == 0) got = atomicAdd(queue, take);
            got = __shfl_sync(kFull, got, 0);
            if (got >= cands_here) {
              drained = true;
              break;
            }
            batch = got;
            batch_end =
                static_cast<int>(min(int64_t{got} + take, cands_here));
          }
          const int avail = batch_end - batch;
          const int rank = __popc(free & ((1u << lane) - 1));
          if ((free >> lane & 1) && rank < avail) {
            i = cand0 + batch + rank;
            q = 0;
#pragma unroll
            for (int d = 0; d < K; ++d) {
              const double v = cands[i * K + d];
              upper[d] = __dadd_rn(v, eps);
              lower[d] = __dsub_rn(v, eps);
              up[d] = __double2float_ru(upper[d]);
            }
          }
          batch += min(__popc(free), avail);
          free = __ballot_sync(kFull, i < 0) & lane_mask;
        }
      }
      if (drained) {
        screen_tail<K>(sm.rows, sm.low, len, whole, i, q, upper, lower, up,
                       out, survivors, count);
        break;
      }
      if (__ballot_sync(kFull, i >= 0) == 0) continue;
      // with a lane free, whether the queue is empty: loaded here, used
      // after the slice, so that its latency hides behind the slice
      const bool look = (__ballot_sync(kFull, i < 0) & lane_mask) != 0;
      int next = 0;
      if (look && lane == 0) next = *reinterpret_cast<volatile int*>(queue);
      bool finished = false, survives = false;
      if (i >= 0) {
        const int end = min(q + kSlice, len);
        const int w = first_witness<K>(sm.rows, sm.low, q, end, up, upper,
                                       lower);
        q = end;
        if (w >= 0 || q == len) {
          out[i] = w >= 0;
          finished = true;
          survives = w < 0 && !whole;
        }
      }
      const unsigned appended = __ballot_sync(kFull, survives);
      if (appended) {
        int at = 0;
        const int leader = __ffs(appended) - 1;
        if (lane == leader) at = atomicAdd(count, __popc(appended));
        at = __shfl_sync(kFull, at, leader);
        if (survives)
          survivors[at + __popc(appended & ((1u << lane) - 1))] =
              static_cast<int>(i);
      }
      if (finished) i = -1;
      // (empty for this warp once its own batch is used up as well)
      if (look) {
        const int head = __shfl_sync(kFull, next, 0);
        drained = batch == batch_end && head >= cands_here;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. split
// ---------------------------------------------------------------------------

// Split: survivors a unit tests together (their float32 bounds in
// registers, uniform over the warp), and rows each lane tests a step.
template <int K>
__host__ __device__ constexpr int group_size() {
  return K <= 4 ? 4 : 2;
}
constexpr int kLaneRows = 4;

template <int K>
struct SplitSmem {
  double chunk[2][chunk_rows<K>() * K];
  float low[2][chunk_rows<K>() * low_stride<K>()];
  // each thread's survivor: float64 bounds, upper rounded up to float32,
  // its rows, and whether a unit found it a witness
  double upper[kThreads][K];
  double lower[kThreads][K];
  float up[kThreads][K];
  long long lo[kThreads];
  long long hi[kThreads];
  int witness[kThreads];               // 1 once a unit found one
  int ids[kThreads];                   // the chunk's live survivors
  int live_in[kWarps];
  uint64_t bar[2];
  long long hull[2];
  int item;
};

// Chunk rows [r0, r1) into `buf`: one bulk copy where aligned (thread 0
// arms `bar`), else 8-byte cp.async by every thread.  Commits one cp.async
// group either way (an empty one for a bulk copy), so that the group count
// stays one per staged chunk.  Returns whether it used the bulk copy.
template <int K>
__device__ __forceinline__ bool stage_chunk(double* buf, uint32_t bar,
                                            const double* rows, int64_t r0,
                                            int64_t r1) {
  const int count = static_cast<int>(r1 - r0) * K;
  const double* src = rows + r0 * K;
  const uint32_t bytes = static_cast<uint32_t>(count) * 8;
  const bool bulk =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0;
  if (bulk) {
    if (threadIdx.x == 0) {
      // generic-proxy reads of this buffer (ordered by the caller's
      // __syncthreads) before the async-proxy write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(buf), src, bytes, bar);
    }
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads)
      cp_async8(buf + e, src + e);
  }
  cp_async_commit();
  return bulk;
}

// The split's work items, sized on the device from the survivor count:
// each a slab of survivors against a partition of the rows, whole chunks
// of `chunk` rows.  Survivors per slab: whole warps, at most one per
// thread, and fewer where there are few, so that the items still come to
// about kWaves per block (an item is at most one slab against one chunk's
// rows).
struct SplitItems {
  int slab_size;
  int64_t slabs, part_rows, items;
};

__device__ __forceinline__ SplitItems split_items(int64_t s_count, int64_t n,
                                                  int chunk) {
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const int64_t target = int64_t{kWaves} * gridDim.x;
  const int64_t per = (s_count * n_chunks + target - 1) / target;
  SplitItems w;
  w.slab_size = static_cast<int>(
      min(int64_t{kThreads}, max(int64_t{32}, (per + 31) / 32 * 32)));
  w.slabs = (s_count + w.slab_size - 1) / w.slab_size;
  const int64_t want = (target + w.slabs - 1) / w.slabs;
  const int64_t parts_wanted = max(int64_t{1}, min(n_chunks, want));
  w.part_rows = (n_chunks + parts_wanted - 1) / parts_wanted * chunk;
  w.items = w.slabs * ((n + w.part_rows - 1) / w.part_rows);
  return w;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const double* __restrict__ rows, int64_t n,
                 const double* __restrict__ cands, double eps, int64_t seg,
                 const int* __restrict__ survivors, int* __restrict__ count,
                 bool* __restrict__ out, unsigned char* __restrict__ done) {
  constexpr int kChunk = chunk_rows<K>();
  constexpr int kGroup = group_size<K>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SplitSmem<K>& sm = *reinterpret_cast<SplitSmem<K>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the work, read on the device: the screen pass has finished (stream
  // order), so the survivor count is final
  const int64_t s_count = *reinterpret_cast<volatile int*>(count);
  if (s_count == 0) return;
  const SplitItems work = split_items(s_count, n, kChunk);
  const int slab_size = work.slab_size;
  const int64_t slabs = work.slabs, part_rows = work.part_rows;
  const int64_t items = work.items;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&sm.bar[0]), 1);
    mbar_init(smem_u32(&sm.bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  unsigned phase = 0;                  // bit b: the parity bar[b] waits on
  for (;;) {
    __syncthreads();                   // the previous item is done with sm
    if (threadIdx.x == 0) {
      sm.item = atomicAdd(count + 1, 1);
      sm.hull[0] = LLONG_MAX;
      sm.hull[1] = LLONG_MIN;
    }
    __syncthreads();
    const int64_t item = sm.item;
    if (item >= items) break;
    const int64_t slab = item % slabs, part = item / slabs;
    const int64_t p_lo = part * part_rows, p_hi = min(p_lo + part_rows, n);

    // this thread's survivor: its slot, candidate, the rows of its test in
    // this partition, and whether it is live here
    const int64_t slot = slab * slab_size + threadIdx.x;
    int64_t cand = 0, lo = p_lo, hi = p_hi;
    bool live = threadIdx.x < slab_size && slot < s_count;
    if (live) {
      cand = survivors[slot];
      if (seg > 0) {
        const int64_t b = cand / seg * seg;
        lo = max(lo, b);
        hi = min(hi, min(b + seg, n));
      }
      live = lo < hi && !__ldcg(done + slot);
    }
    double upper[K], lower[K];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const double v = live ? cands[cand * K + d] : 0.0;
      upper[d] = __dadd_rn(v, eps);
      lower[d] = __dsub_rn(v, eps);
    }
    if (live) {
#pragma unroll
      for (int d = 0; d < K; ++d) {
        sm.upper[threadIdx.x][d] = upper[d];
        sm.lower[threadIdx.x][d] = lower[d];
        sm.up[threadIdx.x][d] = __double2float_ru(upper[d]);
      }
      sm.lo[threadIdx.x] = lo;
      sm.hi[threadIdx.x] = hi;
      atomicMin(&sm.hull[0], static_cast<long long>(lo));
      atomicMax(&sm.hull[1], static_cast<long long>(hi));
    }
    sm.witness[threadIdx.x] = 0;
    __syncthreads();
    const int64_t s_lo = sm.hull[0], s_hi = sm.hull[1];
    if (s_lo >= s_hi) continue;        // every survivor of the slab is done
    const int64_t chunks = (s_hi - s_lo + kChunk - 1) / kChunk;

    unsigned bulk = stage_chunk<K>(sm.chunk[0], smem_u32(&sm.bar[0]), rows,
                                   s_lo, min(s_lo + kChunk, s_hi));
    int64_t t = 0;
    for (; t < chunks; ++t) {
      const int b = t & 1;
      const int64_t c_lo = s_lo + t * kChunk;
      const int64_t c_hi = min(c_lo + kChunk, s_hi);
      const int rows_here = static_cast<int>(c_hi - c_lo);
      const bool more = t + 1 < chunks;
      if (more) {
        const bool by_bulk = stage_chunk<K>(
            sm.chunk[b ^ 1], smem_u32(&sm.bar[b ^ 1]), rows, c_hi,
            min(c_hi + kChunk, s_hi));
        bulk = (bulk & (1u << b)) | (static_cast<unsigned>(by_bulk)
                                     << (b ^ 1));
      }
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
      if (bulk >> b & 1) {
        mbar_wait(smem_u32(&sm.bar[b]), phase >> b & 1);
        phase ^= 1u << b;
      }
      __syncthreads();                 // chunk t is in sm.chunk[b]
      for (int e = threadIdx.x; e < rows_here * K; e += kThreads)
        sm.low[b][e / K * low_stride<K>() + e % K] =
            __double2float_rd(sm.chunk[b][e]);
      __syncthreads();                 // and rounded in sm.low[b]

      // survivors that other items have decided since
      if (t > 0 && live && __ldcg(done + slot)) live = false;
      // The chunk's live survivors, compacted, in groups of kGroup; the
      // work units are (group, slice of the chunk's rows), as many slices
      // per group as keep all the block's warps busy, dealt round the
      // warps.  A unit's lanes stride its rows, kLaneRows rows a lane a
      // step, and test each against the group's members (their float32
      // bounds in registers): a survivor nothing dominates costs a warp
      // step per 128 rows, and few survivors still spread over the block.
      const unsigned ballot = __ballot_sync(kFull, live);
      if (lane == 0) sm.live_in[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, live_count = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        base += w < warp ? sm.live_in[w] : 0;
        live_count += sm.live_in[w];
      }
      if (live)
        sm.ids[base + __popc(ballot & ((1u << lane) - 1))] = threadIdx.x;
      __syncthreads();
      const float* low = sm.low[b];
      const double* buf = sm.chunk[b];
      const int groups = (live_count + kGroup - 1) / kGroup;
      const int slices = groups > 0 && groups < kWarps ? kWarps / groups : 1;
      const int slice_rows =
          (rows_here + 32 * slices - 1) / (32 * slices) * 32;
      for (int unit = warp; unit < groups * slices; unit += kWarps) {
        const int g = unit % groups;
        const int u_lo = unit / groups * slice_rows;
        const int u_hi = min(u_lo + slice_rows, rows_here);
        int who[kGroup], r_lo[kGroup], r_hi[kGroup];
        float gup[kGroup][K];
        unsigned open = 0;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int m = g * kGroup + u;
          who[u] = sm.ids[min(m, live_count - 1)];
          if (m < live_count) open |= 1u << u;
#pragma unroll
          for (int d = 0; d < K; ++d) gup[u][d] = sm.up[who[u]][d];
          r_lo[u] = static_cast<int>(
              min(max(sm.lo[who[u]] - c_lo, 0LL),
                  static_cast<long long>(rows_here)));
          r_hi[u] = static_cast<int>(
              min(max(sm.hi[who[u]] - c_lo, 0LL),
                  static_cast<long long>(rows_here)));
        }
        // bit u * kLaneRows + j of `pass`: member u against the lane's row
        // j of the step
        for (int r0 = u_lo; r0 < u_hi && open; r0 += 32 * kLaneRows) {
          unsigned pass = 0;
#pragma unroll
          for (int j = 0; j < kLaneRows; ++j) {
            const int r = r0 + j * 32 + lane;
            const int rr = min(r, u_hi - 1);
            float x[low_stride<K>()];
#pragma unroll
            for (int d = 0; d < low_stride<K>(); d += 4)
              *reinterpret_cast<float4*>(x + d) =
                  *reinterpret_cast<const float4*>(
                      low + rr * low_stride<K>() + d);
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              bool p = (open >> u & 1) & (r < u_hi) & (r >= r_lo[u]) &
                       (r < r_hi[u]);
#pragma unroll
              for (int d = 0; d < K; ++d) p &= x[d] <= gup[u][d];
              pass |= static_cast<unsigned>(p) << (u * kLaneRows + j);
            }
          }
          const unsigned need = __reduce_or_sync(kFull, pass);
          if (!need) continue;
          // the float64 test of what passed
          unsigned hit = 0;
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
#pragma unroll
            for (int j = 0; j < kLaneRows; ++j) {
              const int bit = u * kLaneRows + j;
              if (!(need >> bit & 1)) continue;
              const int rr = min(r0 + j * 32 + lane, u_hi - 1);
              if ((pass >> bit & 1) &&
                  dominates<K>(buf + rr * K, sm.upper[who[u]],
                               sm.lower[who[u]])) {
                hit |= 1u << bit;
                sm.witness[who[u]] = 1;
              }
            }
          }
          const unsigned found = __reduce_or_sync(kFull, hit);
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            if (found >> (u * kLaneRows) & ((1u << kLaneRows) - 1))
              open &= ~(1u << u);
        }
      }
      __syncthreads();                 // every unit is done with the chunk
      if (live && sm.witness[threadIdx.x]) {
        live = false;
        out[cand] = true;
        done[slot] = 1;
      }
      // a test whose rows end in this chunk is done
      if (live && hi <= c_hi) live = false;
      // every thread is done with chunk t before chunk t + 2 overwrites it
      if (!__syncthreads_or(live)) {
        ++t;
        break;
      }
    }
    // a chunk staged ahead of an early stop: let it land before the
    // buffers are reused
    if (t < chunks) {
      cp_async_wait<0>();
      const int b = t & 1;
      if (bulk >> b & 1) {
        mbar_wait(smem_u32(&sm.bar[b]), phase >> b & 1);
        phase ^= 1u << b;
      }
    }
  }
}

// Blocks of `kernel` the card holds at once with `smem` bytes each.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks,
                            int threads = kThreads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <int K>
cudaError_t launch_screen(const double* rows, int64_t n, const double* cands,
                          int64_t c, double eps, int64_t seg, bool* out,
                          int* survivors, int* count, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(ScreenSmem<K>));
  int blocks = 0;
  cudaError_t err = resident_blocks(screen_kernel<K>, smem, &blocks);
  if (err != cudaSuccess) return err;
  // with seg = 0, a block per 32 candidates at most (each warp then has
  // at least 4); with seg > 0, a block per slab at most
  const int64_t work =
      seg > 0 ? (n + seg - 1) / seg * ((seg + kSegSlab - 1) / kSegSlab)
              : (c + 31) / 32;
  const unsigned grid = static_cast<unsigned>(work < blocks ? work : blocks);
  screen_kernel<K><<<grid, kThreads, smem, stream>>>(
      rows, n, cands, c, eps, seg, out, survivors, count);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_split(const double* rows, int64_t n, const double* cands,
                         double eps, int64_t seg, const int* survivors,
                         int* count, bool* out, unsigned char* done,
                         cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(SplitSmem<K>));
  int blocks = 0;
  cudaError_t err = resident_blocks(split_kernel<K>, smem, &blocks);
  if (err != cudaSuccess) return err;
  split_kernel<K><<<static_cast<unsigned>(blocks), kThreads, smem,
                    stream>>>(rows, n, cands, eps, seg, survivors, count,
                              out, done);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. wide
// ---------------------------------------------------------------------------

// wide: candidates a unit tests together, and rows a lane tests a step
constexpr int kWideGroup = 2;
constexpr int kWideLaneRows = 4;
// wide screen: warps of a block, and the float64 values of shared memory
// its stream and its warps' bounds may take
constexpr int kWideScreenWarps = 16;
constexpr int kWideScreenValues = 28672;
// wide split: float64 values per staged chunk buffer, and rows per chunk
// where the rows are read in place
constexpr int kWideChunk = 4096;
constexpr int kWideRows = 256;

// wide screen: rows of its stream for k objectives: kScreenRows where the
// rows are read in place (k > kWideStage), else as many whole warps of
// rows as kWideScreenValues hold beside the warps' bounds, at most
// kScreenRows
__host__ __device__ inline int wide_screen_rows(int64_t k) {
  if (k > kWideStage) return kScreenRows;
  const int64_t rows =
      (kWideScreenValues / k - 1 - 2 * kWideGroup * kWideScreenWarps) / 32 *
      32;
  return static_cast<int>(rows < kScreenRows ? rows : kScreenRows);
}

// wide split: rows per chunk for k objectives: whole warps of as many rows
// as kWideChunk values hold where the rows are staged (k <= kWideStage),
// else kWideRows
__host__ __device__ inline int wide_chunk_rows(int64_t k) {
  return k <= kWideStage ? static_cast<int>(kWideChunk / k) / 32 * 32
                         : kWideRows;
}

// Stream rows [q0, q1) (row q is rows[(first + q * stride) * k ...]) into
// `buf` column by column: objective d of row q0 + r at d * pitch + r (an
// odd pitch, so that the stores of one row's objectives fall in distinct
// banks, and consecutive lanes read one column without conflicts).  8-byte
// cp.async by every thread of the block (a row is 8k bytes, so neither its
// start nor a column is 16-byte aligned), its (row, objective) stepped
// without a division; commits one group.
__device__ __forceinline__ void wide_stage(double* buf, int pitch,
                                           const double* rows, int64_t k,
                                           int64_t first, int64_t stride,
                                           int64_t q0, int64_t q1) {
  const int kk = static_cast<int>(k), n_rows = static_cast<int>(q1 - q0);
  const int threads = static_cast<int>(blockDim.x);
  const int dr = threads / kk, dd = threads % kk;
  int r = threadIdx.x / kk, d = threadIdx.x % kk;
  for (; r < n_rows; r += dr, d += dd) {
    if (d >= kk) {
      d -= kk;
      ++r;
      if (r >= n_rows) break;
    }
    cp_async8(buf + d * pitch + r, rows + (first + (q0 + r) * stride) * k + d);
  }
  cp_async_commit();
}

// A unit's members' float64 bounds into ub / lb (member u's objective d
// at u * bs + d), the warp's lanes over the objectives.
__device__ __forceinline__ void wide_bounds(double* ub, double* lb,
                                            int64_t bs,
                                            const double* const* cand,
                                            int64_t k, double eps) {
  const int lane = threadIdx.x & 31;
  __syncwarp();                        // the warp's last unit is done
#pragma unroll
  for (int u = 0; u < kWideGroup; ++u)
    for (int64_t d = lane; d < k; d += 32) {
      ub[u * bs + d] = __dadd_rn(cand[u][d], eps);
      lb[u * bs + d] = __dsub_rn(cand[u][d], eps);
    }
  __syncwarp();
}

// One unit of the wide kernels: the members (candidate rows cand[u] for
// the bits u of `open`) against rows [u_lo, u_hi) of a stream, each member
// only on its rows [r_lo[u], r_hi[u]); the warp's lanes stride the rows,
// kWideLaneRows a lane a step.  Objective d of row r is x[r * rs + d * ds].
// The bounds are staged (kStaged: member u's at ub / lb + u * bs), else
// computed again from cand with the same intrinsics, to the same bits.  A
// step tests its (member, row) pairs in two passes, each pair a bit of a
// mask: `<=` against the upper bounds over every objective, four at a
// time, until no pair of the lane still passes, then `<` against the lower
// bounds for the pairs that passed (few: a witness, or a row that ties the
// candidate within the band).  A member stops once a row dominates it.
// Returns the members found dominated (bit u), the same on every lane.
template <bool kStaged>
__device__ __forceinline__ unsigned wide_unit(
    const double* x, int64_t rs, int64_t ds, int64_t k, double eps,
    const double* const* cand, const double* ub, const double* lb,
    int64_t bs, const int* r_lo, const int* r_hi, unsigned open, int u_lo,
    int u_hi) {
  constexpr int J = kWideLaneRows, G = kWideGroup;
  const int lane = threadIdx.x & 31;
  auto upper = [&](int u, int64_t d) {
    return kStaged ? ub[u * bs + d] : __dadd_rn(cand[u][d], eps);
  };
  auto lower = [&](int u, int64_t d) {
    return kStaged ? lb[u * bs + d] : __dsub_rn(cand[u][d], eps);
  };
  unsigned found = 0;
  for (int r0 = u_lo; r0 < u_hi && (open & ~found); r0 += 32 * J) {
    const double* row[J];
    unsigned le = 0;                   // bit u * J + j
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = r0 + j * 32 + lane;
      row[j] = x + min(r, u_hi - 1) * rs;
#pragma unroll
      for (int u = 0; u < G; ++u)
        le |= static_cast<unsigned>((open >> u & 1) & (~found >> u & 1) &
                                    (r < u_hi) & (r >= r_lo[u]) &
                                    (r < r_hi[u]))
              << (u * J + j);
    }
    // pass 1: every objective's `<=` (a pair whose `<=` is false, as with a
    // NaN, drops out of le)
    int64_t d = 0;
    for (; d + 4 <= k && le; d += 4) {
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        double v[J];
#pragma unroll
        for (int j = 0; j < J; ++j) v[j] = row[j][(d + dd) * ds];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const double up = upper(u, d + dd);
#pragma unroll
          for (int j = 0; j < J; ++j)
            le &= v[j] <= up ? ~0u : ~(1u << (u * J + j));
        }
      }
    }
    for (; d < k && le; ++d) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const double up = upper(u, d);
#pragma unroll
        for (int j = 0; j < J; ++j)
          le &= row[j][d * ds] <= up ? ~0u : ~(1u << (u * J + j));
      }
    }
    // pass 2: some objective's `<`, for the pairs that passed
    unsigned hit = 0;                  // bit u: a row of this lane
    for (unsigned pass = le; pass; pass &= pass - 1) {
      const int bit = __ffs(pass) - 1, u = bit / J, j = bit % J;
      bool lt = false;
      for (int64_t e = 0; e < k && !lt; ++e)
        lt = row[j][e * ds] < lower(u, e);
      hit |= static_cast<unsigned>(lt) << u;
    }
    found |= __reduce_or_sync(kFull, hit);
  }
  return found;
}

// ---- the wide screen

// The wide screen's shared memory: its scheduling state, then (kStaged)
// the stream, k columns of wide_screen_rows(k) + 1 values, then each
// warp's members' bounds (member u's upper bounds at (warp * kWideGroup +
// u) * 2k, its lower bounds k after).
struct WideScreenSmem {
  long long staged;                    // first row of the stream held
  int slab;                            // the block's slab
  int queue;                           // the slab's next group
};

inline size_t wide_screen_smem(int64_t k, bool staged) {
  return sizeof(WideScreenSmem) +
         (staged ? sizeof(double) * k *
                       (wide_screen_rows(k) + 1 +
                        2 * kWideGroup * kWideScreenWarps)
                 : 0);
}

// The wide screen: a persistent grid of blocks of kWideScreenWarps warps.
// The candidates are cut into slabs of `slab` (with seg > 0, slabs of one
// block of rows each), which the blocks take from count[2].  A block
// stages its slab's stream, column by column (read in place past
// kWideStage objectives), len = wide_screen_rows(k) rows at most: with
// seg = 0 the stream every candidate is tested against (all n rows where
// n <= len, else the rows q * (n / len), q < len, spread over the array),
// staged once; with seg > 0 the first len rows of the slab's block of
// rows, restaged where the block's last slab was of another block.  Its
// warps take the slab's groups of kWideGroup candidates from a queue in
// shared memory, each group against the whole stream (wide_unit), with no
// barrier between one group and the next.  The warp writes the group's
// verdicts and appends each candidate that is not dominated and whose test
// is longer than the stream to the survivors (one atomicAdd).  With k = 0
// no row is read: no objective can be strictly better, so every verdict
// is false, as the plain version's.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kWideScreenWarps)
    wide_screen_kernel(const double* __restrict__ rows, int64_t n,
                       const double* __restrict__ cands, int64_t c,
                       int64_t k, double eps, int64_t seg, int slab,
                       bool* __restrict__ out, int* __restrict__ survivors,
                       int* __restrict__ count) {
  constexpr int G = kWideGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideScreenSmem& sm = *reinterpret_cast<WideScreenSmem*>(smem_raw);
  double* stream = reinterpret_cast<double*>(smem_raw + sizeof(sm));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (k == 0) {
    for (int64_t i = int64_t{blockIdx.x} * blockDim.x + threadIdx.x; i < c;
         i += int64_t{gridDim.x} * blockDim.x)
      out[i] = false;
    return;
  }
  const int len_max = wide_screen_rows(k), pitch = len_max + 1;
  double* ub = stream + k * pitch + warp * G * 2 * k;
  double* lb = ub + k;
  const int64_t block_cands = seg > 0 ? (seg < n ? seg : n) : c;
  const int64_t per_block = (block_cands + slab - 1) / slab;
  const int64_t slabs =
      seg > 0 ? (n + seg - 1) / seg * per_block : per_block;
  if (threadIdx.x == 0) sm.staged = -1;
  for (;;) {
    __syncthreads();                   // the last slab's groups are done
    if (threadIdx.x == 0) {
      sm.slab = atomicAdd(count + 2, 1);
      sm.queue = 0;
    }
    __syncthreads();
    const int64_t s = sm.slab;
    if (s >= slabs) break;
    const int64_t first = seg > 0 ? s / per_block * seg : 0;
    const int64_t cand0 = first + s % per_block * slab;
    const int64_t end = seg > 0 ? min(first + seg, c) : c;
    const int64_t cands_here =
        max(int64_t{0}, min(int64_t{slab}, end - cand0));
    const int groups = static_cast<int>((cands_here + G - 1) / G);
    const int64_t test = seg > 0 ? min(seg, n - first) : n;
    const int len = static_cast<int>(min(test, int64_t{len_max}));
    const int64_t stride = seg == 0 && n > len ? n / len : 1;
    const bool whole = test <= len;
    if (kStaged && sm.staged != first) {
      wide_stage(stream, pitch, rows, k, first, stride, 0, len);
      cp_async_wait<0>();
      __syncthreads();                 // the stream is in
      if (threadIdx.x == 0) sm.staged = first;
    }
    const double* x = kStaged ? stream : rows + first * k;
    const int64_t rs = kStaged ? 1 : stride * k, ds = kStaged ? pitch : 1;
    for (;;) {
      int g = 0;
      if (lane == 0) g = atomicAdd(&sm.queue, 1);
      g = __shfl_sync(kFull, g, 0);
      if (g >= groups) break;
      const int64_t m0 = int64_t{g} * G;
      const double* cand[G];
      int r_lo[G], r_hi[G];
      unsigned open = 0;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        cand[u] = cands + (cand0 + min(m0 + u, cands_here - 1)) * k;
        r_lo[u] = 0;
        r_hi[u] = len;
        if (m0 + u < cands_here) open |= 1u << u;
      }
      if (kStaged) wide_bounds(ub, lb, 2 * k, cand, k, eps);
      const unsigned found = wide_unit<kStaged>(
          x, rs, ds, k, eps, cand, ub, lb, 2 * k, r_lo, r_hi, open, 0, len);
      // lane u: member u's verdict, and whether it survives
      const bool mine = lane < G && (open >> lane & 1);
      const bool dominated = found >> lane & 1;
      if (mine) out[cand0 + m0 + lane] = dominated;
      const bool survives = mine && !dominated && !whole;
      const unsigned appended = __ballot_sync(kFull, survives);
      if (appended) {
        int at = 0;
        if (lane == 0) at = atomicAdd(count, __popc(appended));
        at = __shfl_sync(kFull, at, 0);
        if (survives)
          survivors[at + __popc(appended & ((1u << lane) - 1))] =
              static_cast<int>(cand0 + m0 + lane);
      }
    }
  }
}

// ---- the wide split

struct WideSmem {
  // each warp's unit: its members' float64 bounds (k <= kWideStage)
  double upper[kWarps][kWideGroup][kWideStage];
  double lower[kWarps][kWideGroup][kWideStage];
  // each thread's slot: its candidate, the rows of its test, and whether
  // a unit found it a witness
  long long cand[kThreads];
  long long lo[kThreads];
  long long hi[kThreads];
  int witness[kThreads];
  int ids[kThreads];                   // the chunk's live slots
  int live_in[kWarps];
  long long hull[2];
  int item;
};

// The wide split's dynamic shared memory: WideSmem and, where the rows are
// staged, two chunk buffers of k columns of wide_chunk_rows(k) + 1 values.
inline size_t wide_split_smem(int64_t k, bool staged) {
  return sizeof(WideSmem) +
         (staged ? 2 * sizeof(double) * k * (wide_chunk_rows(k) + 1) : 0);
}

// A slab of slots against the rows of their tests.  Thread t's slot, where
// `live`, is candidate `cand` (sm.cand[t]) against rows [sm.lo[t],
// sm.hi[t]) (`hi`); [s_lo, s_hi) is the hull of the live slots' rows.  The
// block walks the hull in chunks of wide_chunk_rows(k) rows, staged
// double-buffered in `bufs` (kStaged) or read in place.  At each chunk it
// compacts its live slots into groups of kWideGroup and deals (group,
// slice of the chunk) units round its warps, more slices where there are
// few groups, as split_kernel does.  A witness stores true into out[cand]
// and sets done[slot], which every slot rereads (from L2) before each
// chunk.
template <bool kStaged>
__device__ void wide_walk(WideSmem& sm, double* bufs,
                          const double* __restrict__ rows, int64_t k,
                          double eps, const double* __restrict__ cands,
                          int64_t s_lo, int64_t s_hi, bool live,
                          int64_t cand, int64_t hi, int64_t slot,
                          unsigned char* done, bool* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = wide_chunk_rows(k), pitch = ch + 1;
  const int64_t chunks = (s_hi - s_lo + ch - 1) / ch;
  if (kStaged)
    wide_stage(bufs, pitch, rows, k, 0, 1, s_lo, min(s_lo + ch, s_hi));
  int64_t t = 0;
  for (; t < chunks; ++t) {
    const int b = t & 1;
    const int64_t c_lo = s_lo + t * ch;
    const int64_t c_hi = min(c_lo + ch, s_hi);
    const int rows_here = static_cast<int>(c_hi - c_lo);
    const bool more = t + 1 < chunks;
    if (kStaged) {
      if (more)
        wide_stage(bufs + (b ^ 1) * k * pitch, pitch, rows, k, 0, 1, c_hi,
                   min(c_hi + ch, s_hi));
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    // slots that other items have decided since
    if (t > 0 && live && __ldcg(done + slot)) live = false;
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) sm.live_in[warp] = __popc(ballot);
    __syncthreads();                   // chunk t is in bufs[b]; live_in
    int base = 0, live_count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      base += w < warp ? sm.live_in[w] : 0;
      live_count += sm.live_in[w];
    }
    if (live)
      sm.ids[base + __popc(ballot & ((1u << lane) - 1))] = threadIdx.x;
    __syncthreads();
    const double* x = kStaged ? bufs + b * k * pitch : rows + c_lo * k;
    const int64_t rs = kStaged ? 1 : k, ds = kStaged ? pitch : 1;
    const int groups = (live_count + kWideGroup - 1) / kWideGroup;
    const int slices = groups > 0 && groups < kWarps ? kWarps / groups : 1;
    const int slice_rows =
        (rows_here + 32 * slices - 1) / (32 * slices) * 32;
    for (int unit = warp; unit < groups * slices; unit += kWarps) {
      const int g = unit % groups;
      const int u_lo = unit / groups * slice_rows;
      const int u_hi = min(u_lo + slice_rows, rows_here);
      if (u_lo >= u_hi) continue;
      int who[kWideGroup], r_lo[kWideGroup], r_hi[kWideGroup];
      const double* member[kWideGroup];
      unsigned open = 0;
#pragma unroll
      for (int u = 0; u < kWideGroup; ++u) {
        const int m = g * kWideGroup + u;
        who[u] = sm.ids[min(m, live_count - 1)];
        if (m < live_count) open |= 1u << u;
        member[u] = cands + sm.cand[who[u]] * k;
        r_lo[u] = static_cast<int>(
            min(max(sm.lo[who[u]] - c_lo, 0LL),
                static_cast<long long>(rows_here)));
        r_hi[u] = static_cast<int>(
            min(max(sm.hi[who[u]] - c_lo, 0LL),
                static_cast<long long>(rows_here)));
      }
      if (kStaged)
        wide_bounds(sm.upper[warp][0], sm.lower[warp][0], kWideStage,
                    member, k, eps);
      const unsigned found = wide_unit<kStaged>(
          x, rs, ds, k, eps, member, sm.upper[warp][0], sm.lower[warp][0],
          kWideStage, r_lo, r_hi, open, u_lo, u_hi);
#pragma unroll
      for (int u = 0; u < kWideGroup; ++u)
        if ((found >> u & 1) && lane == 0) sm.witness[who[u]] = 1;
    }
    __syncthreads();                   // every unit is done with the chunk
    if (live && sm.witness[threadIdx.x]) {
      live = false;
      out[cand] = true;
      done[slot] = 1;
    }
    // a test whose rows end in this chunk is done
    if (live && hi <= c_hi) live = false;
    // every thread is done with chunk t before chunk t + 2 overwrites it
    if (!__syncthreads_or(live)) {
      ++t;
      break;
    }
  }
  // a chunk staged ahead of an early stop: let it land before the buffers
  // are reused
  if (kStaged && t < chunks) cp_async_wait<0>();
}

// The wide split: split_kernel's persistent grid, items and done flags,
// each item's slab of survivors walked through wide_walk.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    wide_split_kernel(const double* __restrict__ rows, int64_t n,
                      const double* __restrict__ cands, int64_t k,
                      double eps, int64_t seg,
                      const int* __restrict__ survivors,
                      int* __restrict__ count, bool* __restrict__ out,
                      unsigned char* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideSmem& sm = *reinterpret_cast<WideSmem*>(smem_raw);
  double* bufs = reinterpret_cast<double*>(smem_raw + sizeof(WideSmem));
  const int64_t s_count = *reinterpret_cast<volatile int*>(count);
  if (s_count == 0) return;
  const SplitItems work = split_items(s_count, n, wide_chunk_rows(k));
  const int slab_size = work.slab_size;
  const int64_t slabs = work.slabs, part_rows = work.part_rows;
  const int64_t items = work.items;
  for (;;) {
    __syncthreads();                   // the previous item is done with sm
    if (threadIdx.x == 0) {
      sm.item = atomicAdd(count + 1, 1);
      sm.hull[0] = LLONG_MAX;
      sm.hull[1] = LLONG_MIN;
    }
    __syncthreads();
    const int64_t item = sm.item;
    if (item >= items) break;
    const int64_t slab = item % slabs, part = item / slabs;
    const int64_t p_lo = part * part_rows, p_hi = min(p_lo + part_rows, n);
    const int64_t slot = slab * slab_size + threadIdx.x;
    int64_t cand = 0, lo = p_lo, hi = p_hi;
    bool live = threadIdx.x < slab_size && slot < s_count;
    if (live) {
      cand = survivors[slot];
      if (seg > 0) {
        const int64_t b = cand / seg * seg;
        lo = max(lo, b);
        hi = min(hi, min(b + seg, n));
      }
      live = lo < hi && !__ldcg(done + slot);
    }
    if (live) {
      sm.cand[threadIdx.x] = cand;
      sm.lo[threadIdx.x] = lo;
      sm.hi[threadIdx.x] = hi;
      atomicMin(&sm.hull[0], static_cast<long long>(lo));
      atomicMax(&sm.hull[1], static_cast<long long>(hi));
    }
    sm.witness[threadIdx.x] = 0;
    __syncthreads();
    const int64_t s_lo = sm.hull[0], s_hi = sm.hull[1];
    if (s_lo >= s_hi) continue;        // every survivor of the slab is done
    wide_walk<kStaged>(sm, bufs, rows, k, eps, cands, s_lo, s_hi, live,
                       cand, hi, slot, done, out);
  }
}

template <bool kStaged>
cudaError_t launch_wide_screen(const double* rows, int64_t n,
                               const double* cands, int64_t c, int64_t k,
                               double eps, int64_t seg, bool* out,
                               int* survivors, int* count,
                               cudaStream_t stream) {
  const int threads = 32 * kWideScreenWarps;
  const int smem = static_cast<int>(wide_screen_smem(k, kStaged && k > 0));
  int blocks = 0;
  cudaError_t err = resident_blocks(wide_screen_kernel<kStaged>, smem,
                                    &blocks, threads);
  if (err != cudaSuccess) return err;
  // A slab is a block's share of the candidates, a group for each warp at
  // least; with seg > 0 each block of rows is cut into such slabs.
  const int64_t full = int64_t{kWideGroup} * kWideScreenWarps;
  const int64_t share = (c + blocks - 1) / blocks;
  const int64_t slab = share > full ? (share + full - 1) / full * full : full;
  const int64_t block_cands = seg > 0 && seg < n ? seg : c;
  const int64_t work = (seg > 0 ? (n + seg - 1) / seg : 1) *
                       ((block_cands + slab - 1) / slab);
  const unsigned grid = static_cast<unsigned>(work < blocks ? work : blocks);
  wide_screen_kernel<kStaged><<<grid, threads, smem, stream>>>(
      rows, n, cands, c, k, eps, seg, static_cast<int>(slab), out,
      survivors, count);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t launch_wide_split(const double* rows, int64_t n,
                              const double* cands, int64_t k, double eps,
                              int64_t seg, const int* survivors, int* count,
                              bool* out, unsigned char* done,
                              cudaStream_t stream) {
  const int smem = static_cast<int>(wide_split_smem(k, kStaged));
  int blocks = 0;
  cudaError_t err = resident_blocks(wide_split_kernel<kStaged>, smem,
                                    &blocks);
  if (err != cudaSuccess) return err;
  wide_split_kernel<kStaged><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(rows, n, cands, k, eps, seg,
                                         survivors, count, out, done);
  return cudaGetLastError();
}

bool valid(int64_t n, int64_t c, int64_t seg) {
  return n >= 0 && c >= 0 && seg >= 0 && n <= INT32_MAX && c <= INT32_MAX;
}

}  // namespace

extern "C" {

// The largest objective count k the kernels take.
int pareto_dominated_max_objectives() { return kMaxObjectives; }

// The most rows the screen pass tests a candidate against.
int pareto_dominated_screen_rows() { return kScreenRows; }

// The most objectives the wide kernels stage in shared memory (the rows
// and the candidates' bounds); they read more in place.
int pareto_dominated_wide_stage() { return kWideStage; }

// The most rows the wide screen tests a candidate against for k objectives.
int pareto_dominated_wide_screen_rows(int k) {
  return k > 0 ? wide_screen_rows(k) : kScreenRows;
}

// The screen pass: dominated (c,) bool for candidates (c, k) against rows
// (n, k), float64, contiguous, on the device; seg > 0 tests candidate i
// only against rows [i / seg * seg, i / seg * seg + seg).  A candidate
// whose test is longer than the screen's rows and that the screen does not
// find dominated is appended to `survivors` (int32, room for c), counted
// in count[0], and count[2] is its queue; count[0..2] must be 0.
// Launches one kernel on `stream`
// and returns its CUDA error code (0 on success; cudaErrorInvalidValue for
// k outside 1..kMaxObjectives, which pareto_dominated_wide_screen takes,
// or a count outside 0..2^31 - 1).
int pareto_dominated_screen(const double* rows, int64_t n,
                            const double* cands, int64_t c, int k,
                            double eps, int64_t seg, bool* out,
                            int* survivors, int* count,
                            cudaStream_t stream) {
  if (!valid(n, c, seg)) return cudaErrorInvalidValue;
  if (c == 0) return cudaSuccess;
  switch (k) {
#define CASE(K)                                                         \
  case K:                                                               \
    return launch_screen<K>(rows, n, cands, c, eps, seg, out, survivors, \
                            count, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// The split pass, after the screen pass on the same stream and operands:
// each of the count[0] survivors against every row of its test, out[i]
// set where one dominates it.  count[1] counts the work items taken;
// `done` (uint8, room for c) must be 0.
// Launches one kernel on `stream` (a persistent grid: the blocks the card
// holds at once) and returns its CUDA error code.
int pareto_dominated_split(const double* rows, int64_t n,
                           const double* cands, int64_t c, int k,
                           double eps, int64_t seg, bool* out,
                           const int* survivors, int* count,
                           unsigned char* done, cudaStream_t stream) {
  if (!valid(n, c, seg)) return cudaErrorInvalidValue;
  if (c == 0 || n == 0) return cudaSuccess;
  switch (k) {
#define CASE(K)                                                          \
  case K:                                                                \
    return launch_split<K>(rows, n, cands, eps, seg, survivors, count,   \
                           out, done, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// The wide screen, for any objective count k >= 0 (the binding sends it
// k > kMaxObjectives and k = 0), with the operands, `survivors` and
// `count` of pareto_dominated_screen (count[2] its queue), tests of at
// most pareto_dominated_wide_screen_rows(k) rows decided whole: every
// verdict, and the survivors the wide split takes.  Launches one kernel on
// `stream` (a persistent grid) and returns its CUDA error code
// (cudaErrorInvalidValue for k < 0 or a count outside 0..2^31 - 1).
int pareto_dominated_wide_screen(const double* rows, int64_t n,
                                 const double* cands, int64_t c, int k,
                                 double eps, int64_t seg, bool* out,
                                 int* survivors, int* count,
                                 cudaStream_t stream) {
  if (!valid(n, c, seg) || k < 0) return cudaErrorInvalidValue;
  if (c == 0) return cudaSuccess;
  return k <= kWideStage
             ? launch_wide_screen<true>(rows, n, cands, c, k, eps, seg, out,
                                        survivors, count, stream)
             : launch_wide_screen<false>(rows, n, cands, c, k, eps, seg, out,
                                         survivors, count, stream);
}

// The wide split, after the wide screen on the same stream and operands,
// as pareto_dominated_split is after the screen (k >= 1).  Launches one
// kernel on `stream` (a persistent grid) and returns its CUDA error code.
int pareto_dominated_wide_split(const double* rows, int64_t n,
                                const double* cands, int64_t c, int k,
                                double eps, int64_t seg, bool* out,
                                const int* survivors, int* count,
                                unsigned char* done, cudaStream_t stream) {
  if (!valid(n, c, seg) || k < 1) return cudaErrorInvalidValue;
  if (c == 0 || n == 0) return cudaSuccess;
  return k <= kWideStage
             ? launch_wide_split<true>(rows, n, cands, k, eps, seg,
                                       survivors, count, out, done, stream)
             : launch_wide_split<false>(rows, n, cands, k, eps, seg,
                                        survivors, count, out, done, stream);
}

const char* pareto_dominated_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
