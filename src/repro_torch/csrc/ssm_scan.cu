// ssm_scan: the chunked diagonal linear recurrence on Hopper.
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
// kernel scans it by log-depth doubling (7 vector passes for bt = 128
// instead of 128 serial steps).  On the card each thread owns one column d
// and is itself a sequential processor: it walks T, one multiply and one
// add per row, which is fewer operations than the doubling and the same
// order of rounding as the sequential plain version.  The multiply and the
// add are written __fmul_rn/__fadd_rn, so nvcc cannot contract them into an
// FMA: every depth computes the same bits as every other, and as the
// sequential plain version (a multiply, then an add, each rounded).
// The TPU kernel's sequential T grid axis and VMEM carry become the loop in
// the thread and a register.  Rows past T and columns past D are masked,
// instead of the TPU's padding with a = 1, b = 0.
//
// Rows reach the thread in chunks of bt, staged in shared memory as
// [slot][a|b][row][thread]: a warp's loads of one row are 128 contiguous
// bytes, and no thread reads another's column, so no barrier is needed.
//   depth 1 (ssm_scan_pallas):   each chunk is loaded with plain loads, all
//                                all bt rows requested before the scan.
//   depth 2..4 (the pipelined):  a depth-slot cp.async ring: chunks
//                                c+1..c+depth-1 are in flight while chunk c
//                                is scanned, the TPU kernel's depth-slot DMA
//                                rotation.  States go straight to global
//                                memory: the card's stores do not stall the
//                                thread, so the TPU's output staging ring
//                                has no counterpart.
//
// Bound on the H100 SXM: 12 bytes per element (a and b read, the state
// written) at 3.35 TB/s against 2 float operations at 67 TFLOP/s: bytes
// bound it.  At D = 256 only 256 threads run (2 blocks of 128): a latency
// chain of T steps on 2 of 132 SMs, far from the bound; a chunk-parallel
// scan across blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One chunk: rows [c*bt, c*bt + rows) from slot `buf` ([a|b][bt][B]).
__device__ __forceinline__ float scan_chunk(const float* buf, int bt, int B,
                                            int t, float h, float* states,
                                            size_t row0, int rows, int D,
                                            int d, bool active) {
  const float* sa = buf;
  const float* sb = buf + (size_t)bt * B;
  for (int r = 0; r < rows; ++r) {
    h = __fadd_rn(__fmul_rn(sa[r * B + t], h), sb[r * B + t]);
    if (active) states[(row0 + r) * D + d] = h;
  }
  return h;
}

template <int DEPTH>
__global__ void __launch_bounds__(1024)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ states,
                float* __restrict__ final_state, int T, int D, int bt) {
  extern __shared__ float smem[];  // [DEPTH][2][bt][blockDim.x]
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const int d = blockIdx.x * B + t;
  const bool active = d < D;
  const int n_chunks = (T + bt - 1) / bt;
  const size_t slot = (size_t)2 * bt * B;
  float h = active ? h0[d] : 0.f;

  if constexpr (DEPTH == 1) {
    for (int c = 0; c < n_chunks; ++c) {
      const int rows = min(bt, T - c * bt);
      if (active) {
        for (int r = 0; r < rows; ++r) {
          const size_t g = ((size_t)c * bt + r) * D + d;
          smem[r * B + t] = a[g];
          smem[(size_t)bt * B + r * B + t] = b[g];
        }
      }
      h = scan_chunk(smem, bt, B, t, h, states, (size_t)c * bt, rows, D, d,
                     active);
    }
  } else {
    // Chunk c goes to slot c % DEPTH; every iteration commits one group
    // (empty past the last chunk), so waiting until at most DEPTH - 1
    // groups are pending means chunk c has landed.
    auto fetch = [&](int c) {
      if (active && c < n_chunks) {
        float* buf = smem + (size_t)(c % DEPTH) * slot;
        const int rows = min(bt, T - c * bt);
        for (int r = 0; r < rows; ++r) {
          const size_t g = ((size_t)c * bt + r) * D + d;
          cp_async4(buf + r * B + t, a + g);
          cp_async4(buf + (size_t)bt * B + r * B + t, b + g);
        }
      }
      cp_async_commit();
    };
    for (int c = 0; c < DEPTH; ++c) fetch(c);
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<DEPTH - 1>();
      const int rows = min(bt, T - c * bt);
      h = scan_chunk(smem + (size_t)(c % DEPTH) * slot, bt, B, t, h, states,
                     (size_t)c * bt, rows, D, d, active);
      // The slot just read is refilled with chunk c + DEPTH.  Its reads
      // came first; the warp barrier orders them before the copy.
      __syncwarp();
      fetch(c + DEPTH);
    }
    cp_async_wait<0>();
  }
  if (active) final_state[d] = h;
}

template <int DEPTH>
int launch(const float* a, const float* b, const float* h0, float* states,
           float* final_state, int T, int D, int bt, int bd,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * DEPTH * (size_t)bt * bd;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<DEPTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (D + bd - 1) / bd;
  ssm_scan_kernel<DEPTH><<<blocks, bd, smem, stream>>>(a, b, h0, states,
                                                       final_state, T, D, bt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b (T, D) float32, h0 (D,) -> states (T, D), final (D,) on `stream`, in
// chunks of bt rows over blocks of bd columns; depth 1 is the plain-load
// kernel, 2..4 the cp.async ring.  Returns the CUDA error code of the launch
// (0 on success; cudaErrorInvalidValue for another depth).
int ssm_scan(const void* a, const void* b, const void* h0, void* states,
             void* final_state, int T, int D, int bt, int bd, int depth,
             void* stream) {
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* ph = static_cast<const float*>(h0);
  float* ps = static_cast<float*>(states);
  float* pf = static_cast<float*>(final_state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1: return launch<1>(pa, pb, ph, ps, pf, T, D, bt, bd, s);
    case 2: return launch<2>(pa, pb, ph, ps, pf, T, D, bt, bd, s);
    case 3: return launch<3>(pa, pb, ph, ps, pf, T, D, bt, bd, s);
    case 4: return launch<4>(pa, pb, ph, ps, pf, T, D, bt, bd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
