// ssm_scan: the chunked diagonal linear recurrence on Hopper, as a
// deterministic chunk-parallel scan.
//
// Replaces the Pallas TPU kernels of repro/kernels/ssm_scan/kernel.py:
//   ssm_scan_pallas            (_scan_chunk_kernel)     -> ssm_scan, depth 1
//   ssm_scan_pipelined_pallas  (_scan_pipelined_kernel) -> ssm_scan, depth 2-4
//
// What it computes: h_t = a_t * h_{t-1} + b_t over T steps of a width-D
// float32 state, h_{-1} = h0; it writes every state (T, D) and the final
// state (D,), which is the state after the last real row.
//
// Design.  On the TPU a chunk of bt rows is a few vector registers, so the
// kernel scans it by log-depth doubling and carries the state along a
// sequential grid axis.  On the card one thread per column is itself a
// sequential processor, but D columns alone leave the card idle when D is
// small (256 columns are 2 blocks on 132 SMs).  So T is cut into S chunks
// of L rows, (S, L) a function of (T, D) only (ssm_chunks in
// kernels/ssm_scan/ref.py), and the scan runs in three passes, each in a
// fixed order, in two launches on the stream:
//   1. launch 1, scan_kernel<kSummary = true>, one thread per (chunk,
//      column), every chunk but the last: from a zero state, the chunk's
//      decay product A_c = a_0 a_1 ... and its end state B_c;
//   2. launch 2, scan_kernel<kSummary = false>, one thread per (chunk,
//      column): first the state entering its chunk, from h0 through the
//      summaries of the chunks before it in order, h_in[c+1] = A_c h_in[c]
//      + B_c (carry_in);
//   3. then, in the same thread, the chunk re-scanned from h_in[c],
//      writing its states (and the last chunk the final state).
// Launch 2 of a chunked scan is a programmatic dependent launch (Hopper):
// it may start as soon as every block of launch 1 is running, issues its
// first rows' loads, and only then waits (griddepcontrol.wait) for launch
// 1's summaries, so its launch and loads overlap launch 1
// (probes/ssm_launch.py times it against an ordinary stream-ordered
// launch).  Every step is a multiply, then an add, written
// __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA.  Nothing depends on timing or on the tile:
// every depth, every bt and bd, and the plain version ssm_scan_chunked_ref
// compute the same bits.  With S = 1 (D wide enough to fill the card, as
// the zamba2 state's 262,144 columns do) only launch 2 runs: the
// sequential scan of every column.  The TPU kernel's padding with a = 1,
// b = 0 becomes masks on rows past T and columns past D.
//
// Passes 1 and 3 stage a chunk's rows in sub-chunks of bt rows in shared
// memory as [slot][a|b][row][thread]: a warp's loads of one row are 128
// contiguous bytes, and no thread reads another's column, so no barrier is
// needed.
//   depth 1 (ssm_scan_pallas):   each sub-chunk is loaded with plain loads,
//                                all its rows requested before the scan.
//   depth 2..4 (the pipelined):  a depth-slot cp.async ring: sub-chunks
//                                c+1..c+depth-1 are in flight while c is
//                                scanned, the TPU kernel's depth-slot DMA
//                                rotation.  States go straight to global
//                                memory: the card's stores do not stall the
//                                thread, so the TPU's output staging ring
//                                has no counterpart.
//
// Profiling skeletons (kernels/profile.py; the TPU kernel's _mode of
// _scan_pipelined_kernel): scan_kernel's MODE template parameter, at every
// depth, compiled with -DSKELETONS into a library of their own
// (kernels/build.py) so that the main path's build is unchanged.  Each
// computes a data token defined by its plain version in
// kernels/ssm_scan/ref.py:
//   COPY     the same launches, loads and stores, no recurrence: every
//            state is __fadd_rn(a, b); launch 2 skips pass 2 but waits for
//            launch 1 where pass 2 would; the final state follows the TPU
//            kernel's rule at the tile's bt: the last state if bt does not
//            divide T, else h0 (the TPU copy skeleton never moves h).
//   COMPUTE  the recurrence on resident data: each chunk's first
//            sub-chunk is loaded once and every sub-chunk's walk (passes
//            1-3) reads it; no state is written, the final state is.
//
// Bound on the H100 SXM: 12 bytes per element (a and b read, the state
// written) at 3.35 TB/s against 2 float operations at 67 TFLOP/s: bytes
// bound it.  Pass 3 reads a and b a second time; at D = 256 they are a few
// MB and come from the 50 MB L2.  Both launches run S x D threads, so a
// narrow state fills the card; pass 2 is a chain of at most S - 1 steps
// per thread whose summaries are loaded kAhead at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// scan_kernel's modes: the scan, and its two profiling skeletons.
enum Mode { FUSED = 0, COPY = 1, COMPUTE = 2 };

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Both are no-ops in a grid that was not launched as a programmatic
// dependent (or has none).
__device__ __forceinline__ void wait_for_primary_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Pass 2 for one column: the state entering chunk `chunk`, from h0 through
// the summaries ([A | B], each (n, D)) of chunks 0..chunk-1 in order.  The
// summaries come from launch 1, so it waits for that grid first; they are
// read through L2 (ld.global.cg), kAhead chunks ahead of the chain.
__device__ __forceinline__ float carry_in(const float* summary,
                                          const float* h0, int chunk, int n,
                                          int D, int d) {
  constexpr int kAhead = 16;
  float h = h0[d];
  if (chunk == 0) return h;
  wait_for_primary_grid();
  const float* prod = summary;
  const float* end = summary + (size_t)n * D;
  for (int c0 = 0; c0 < chunk; c0 += kAhead) {
    float p[kAhead], e[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < chunk) {
        p[k] = __ldcg(prod + (size_t)(c0 + k) * D + d);
        e[k] = __ldcg(end + (size_t)(c0 + k) * D + d);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < chunk) h = __fadd_rn(__fmul_rn(p[k], h), e[k]);
    }
  }
  return h;
}

// One staged sub-chunk of `rows` rows from slot `buf` ([a|b][bt][B]),
// starting at row `row0`: advances the state h and, for a summary, the
// decay product; otherwise writes the states (COMPUTE: none).  COPY: h
// is each row's a + b, written as its state.
template <bool kSummary, int MODE>
__device__ __forceinline__ void scan_rows(const float* buf, int bt, int B,
                                          int t, float& h, float& prod,
                                          float* states, size_t row0,
                                          int rows, int D, int d,
                                          bool active) {
  const float* sa = buf;
  const float* sb = buf + (size_t)bt * B;
  for (int r = 0; r < rows; ++r) {
    const float av = sa[r * B + t];
    if constexpr (MODE == COPY) {
      h = __fadd_rn(av, sb[r * B + t]);
    } else {
      if constexpr (kSummary) prod = __fmul_rn(av, prod);
      h = __fadd_rn(__fmul_rn(av, h), sb[r * B + t]);
    }
    if constexpr (!kSummary && MODE != COMPUTE) {
      if (active) states[(row0 + r) * D + d] = h;
    }
  }
}

// Pass 1 (kSummary) or passes 2 and 3 on chunk blockIdx.y, rows [c L,
// min(T, (c + 1) L)), one thread per column of the block's bd columns.
//   launch 1: out = summary [A | B], each (gridDim.y, D); h starts at 0.
//   launch 2: out = states (T, D); h starts at carry_in (h0 for chunk 0),
//             summary is launch 1's (gridDim.y - 1 chunks); the last
//             chunk writes final_state.
// `copy_last` (COPY only): the final state is the last state, not h0.
template <int DEPTH, bool kSummary, int MODE>
__global__ void __launch_bounds__(1024)
scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ h0, const float* summary,
            float* __restrict__ out, float* __restrict__ final_state, int T,
            int D, int bt, int L, int copy_last) {
  extern __shared__ float smem[];  // [DEPTH][2][bt][blockDim.x]
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const int d = blockIdx.x * B + t;
  const bool active = d < D;
  const int chunk = blockIdx.y;
  const size_t r0 = (size_t)chunk * L;  // the chunk's first row
  const int rows_c = min(L, T - chunk * L);
  const int n_sub = (rows_c + bt - 1) / bt;
  const size_t slot = (size_t)2 * bt * B;
  float prod = 1.f;
  float h = 0.f;
  if constexpr (kSummary) allow_dependent_grid();
  // Launch 2 enters its chunk with the carry of pass 2; the copy skeleton
  // only waits for launch 1 where pass 2 would.
  auto enter = [&] {
    if constexpr (!kSummary) {
      if constexpr (MODE == COPY) {
        if (chunk > 0) wait_for_primary_grid();
      } else if (active) {
        h = carry_in(summary, h0, chunk, gridDim.y - 1, D, d);
      }
    }
  };

  if constexpr (MODE == COMPUTE) {
    // one load: the chunk's first sub-chunk, which every sub-chunk's walk
    // then reads
    if (active) {
      for (int r = 0; r < min(bt, rows_c); ++r) {
        const size_t g = (r0 + r) * D + d;
        smem[r * B + t] = a[g];
        smem[(size_t)bt * B + r * B + t] = b[g];
      }
    }
    enter();
    for (int c = 0; c < n_sub; ++c)
      scan_rows<kSummary, MODE>(smem, bt, B, t, h, prod, out,
                                r0 + (size_t)c * bt,
                                min(bt, rows_c - c * bt), D, d, active);
  } else if constexpr (DEPTH == 1) {
    enter();
    for (int c = 0; c < n_sub; ++c) {
      const int rows = min(bt, rows_c - c * bt);
      if (active) {
        for (int r = 0; r < rows; ++r) {
          const size_t g = (r0 + (size_t)c * bt + r) * D + d;
          smem[r * B + t] = a[g];
          smem[(size_t)bt * B + r * B + t] = b[g];
        }
      }
      scan_rows<kSummary, MODE>(smem, bt, B, t, h, prod, out,
                                r0 + (size_t)c * bt, rows, D, d, active);
    }
  } else {
    // Sub-chunk c goes to slot c % DEPTH; every iteration commits one
    // group (empty past the last sub-chunk), so waiting until at most
    // DEPTH - 1 groups are pending means sub-chunk c has landed.
    auto fetch = [&](int c) {
      if (active && c < n_sub) {
        float* buf = smem + (size_t)(c % DEPTH) * slot;
        const int rows = min(bt, rows_c - c * bt);
        for (int r = 0; r < rows; ++r) {
          const size_t g = (r0 + (size_t)c * bt + r) * D + d;
          cp_async4(buf + r * B + t, a + g);
          cp_async4(buf + (size_t)bt * B + r * B + t, b + g);
        }
      }
      cp_async_commit();
    };
    for (int c = 0; c < DEPTH; ++c) fetch(c);
    enter();
    for (int c = 0; c < n_sub; ++c) {
      cp_async_wait<DEPTH - 1>();
      const int rows = min(bt, rows_c - c * bt);
      scan_rows<kSummary, MODE>(smem + (size_t)(c % DEPTH) * slot, bt, B, t,
                                h, prod, out, r0 + (size_t)c * bt, rows, D,
                                d, active);
      // The slot just read is refilled with sub-chunk c + DEPTH.  Its
      // reads came first; the warp barrier orders them before the copy.
      __syncwarp();
      fetch(c + DEPTH);
    }
    cp_async_wait<0>();
  }
  if (!active) return;
  if constexpr (kSummary) {
    out[(size_t)chunk * D + d] = prod;
    out[((size_t)gridDim.y + chunk) * D + d] = h;
  } else if (chunk == (int)gridDim.y - 1) {
    final_state[d] = MODE == COPY && !copy_last ? h0[d] : h;
  }
}

// One launch: launch 1 (kSummary) or launch 2 at depth DEPTH.
template <int DEPTH, bool kSummary, int MODE>
int launch(const float* a, const float* b, const float* h0,
           const float* summary, float* out, float* final_state, int T,
           int D, int bt, int bd, int S, int L, cudaStream_t stream) {
  // A sub-chunk never needs more rows than a chunk has.
  const int sub = min(bt, L);
  const size_t smem = sizeof(float) * 2 * DEPTH * (size_t)sub * bd;
  const dim3 grid((D + bd - 1) / bd, kSummary ? S - 1 : S);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<DEPTH, kSummary, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Launch 2 after launch 1 (S > 1) may start while launch 1 runs;
  // carry_in waits for it.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(bd);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = !kSummary && S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, scan_kernel<DEPTH, kSummary, MODE>, a, b,
                           h0, summary, out, final_state, T, D, sub, L,
                           (int)(T % bt != 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSummary, int MODE>
int launch_depth(int depth, const void* a, const void* b, const void* h0,
                 const void* summary, void* out, void* final_state, int T,
                 int D, int bt, int bd, int S, int L, void* stream) {
  // S chunks of L rows must cover T rows, the last one non-empty.
  if (S < 1 || S > 65535 || L < 1 || (long long)(S - 1) * L >= T ||
      (long long)S * L < T || (kSummary && S == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* ph = static_cast<const float*>(h0);
  const float* pw = static_cast<const float*>(summary);
  float* po = static_cast<float*>(out);
  float* pf = static_cast<float*>(final_state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1:
      return launch<1, kSummary, MODE>(pa, pb, ph, pw, po, pf, T, D, bt,
                                       bd, S, L, s);
    case 2:
      return launch<2, kSummary, MODE>(pa, pb, ph, pw, po, pf, T, D, bt,
                                       bd, S, L, s);
    case 3:
      return launch<3, kSummary, MODE>(pa, pb, ph, pw, po, pf, T, D, bt,
                                       bd, S, L, s);
    case 4:
      return launch<4, kSummary, MODE>(pa, pb, ph, pw, po, pf, T, D, bt,
                                       bd, S, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The scan of a, b (T, D) float32 from h0 (D,) cuts T into S chunks of L
// rows (S = ceil(T / L) <= 65535), staged in sub-chunks of bt rows over
// blocks of bd columns; depth 1 is the plain-load kernel, 2..4 the
// cp.async ring.  Each function below launches one kernel on `stream` and
// returns its CUDA error code (0 on success; cudaErrorInvalidValue for
// another depth or an inconsistent split).

#ifdef SKELETONS

// The profiling skeleton `mode` (1 COPY, 2 COMPUTE) of launch 1 and of
// launch 2, with the arguments of ssm_scan_summary and ssm_scan_states
// (COMPUTE writes no states).
int ssm_scan_skeleton_summary(int mode, const void* a, const void* b,
                              void* summary, int T, int D, int bt, int bd,
                              int depth, int S, int L, void* stream) {
  switch (mode) {
    case COPY:
      return launch_depth<true, COPY>(depth, a, b, nullptr, nullptr, summary,
                                      nullptr, T, D, bt, bd, S, L, stream);
    case COMPUTE:
      return launch_depth<true, COMPUTE>(depth, a, b, nullptr, nullptr,
                                         summary, nullptr, T, D, bt, bd, S,
                                         L, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int ssm_scan_skeleton_states(int mode, const void* a, const void* b,
                             const void* h0, const void* summary,
                             void* states, void* final_state, int T, int D,
                             int bt, int bd, int depth, int S, int L,
                             void* stream) {
  switch (mode) {
    case COPY:
      return launch_depth<false, COPY>(depth, a, b, h0, summary, states,
                                       final_state, T, D, bt, bd, S, L,
                                       stream);
    case COMPUTE:
      return launch_depth<false, COMPUTE>(depth, a, b, h0, summary, states,
                                          final_state, T, D, bt, bd, S, L,
                                          stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#else

// Launch 1 (S > 1 only): the summaries of chunks 0..S-2 into `summary`,
// 2 (S - 1) D floats.
int ssm_scan_summary(const void* a, const void* b, void* summary, int T,
                     int D, int bt, int bd, int depth, int S, int L,
                     void* stream) {
  return launch_depth<true, FUSED>(depth, a, b, nullptr, nullptr, summary,
                                   nullptr, T, D, bt, bd, S, L, stream);
}

// Launch 2: states (T, D) and final (D,), from h0 and launch 1's
// `summary` (unused when S = 1).  For S > 1 it must directly follow launch
// 1 on `stream`: it is launched as launch 1's programmatic dependent.
int ssm_scan_states(const void* a, const void* b, const void* h0,
                    const void* summary, void* states, void* final_state,
                    int T, int D, int bt, int bd, int depth, int S, int L,
                    void* stream) {
  return launch_depth<false, FUSED>(depth, a, b, h0, summary, states,
                                    final_state, T, D, bt, bd, S, L, stream);
}

#endif  // SKELETONS

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
