// csa_tree: the DCIM macro's carry-save adder tree (paper Fig. 4) on Hopper.
//
// Replaces the Pallas TPU kernels of repro/kernels/csa_tree/kernel.py:
//   csa_tree_pallas        (_csa_kernel)        -> csa_tree_rows
//   csa_tree_tiled_pallas  (_csa_tiled_kernel)  -> csa_tree_tiled
//
// What it computes: out[n] = sum_h x[h][n] for an (H, N) int32 operand
// stack, as 32-bit words that wrap mod 2^32 (JAX int32 wraps the same
// way), by executing the reduction schedule of the synthesized adder tree:
// 4-2 compressors as two chained full adders on XOR/AND/OR/shift, level by
// level, then a final ripple add.  The schedule is the thing being ported
// (it mirrors the netlist of repro_torch/core/csa.py), so the kernel runs
// it op for op instead of adding the column.
//
// Design.  The TPU kernel unrolls the schedule at trace time over all H
// rows; a per-thread unroll of 512 lanes would spill past Hopper's 255
// registers.  Instead the host builds the schedule once per row count as a
// small op program (build_schedule in repro_torch/kernels/csa_tree/ref.py)
// and the kernel interprets it.  An op is four ints (kind, x, y, z) on
// lane slots:
//   FA:  slot x <- x ^ y ^ z,  slot y <- maj(x, y, z) << 1   (z < 0 reads 0)
//   ADD: slot x <- x + y
// Outputs overwrite input slots, so the program needs no more slots than
// rows.  Each thread owns one column; its lanes live in shared memory as
// lane[slot][thread], so a warp's 32 accesses to one slot hit 32 banks, and
// no thread reads another's column: the kernel has no barrier.  All threads
// run the same op at the same time, so the op fetch is one broadcast load
// and the branch on its kind never diverges.
//
// csa_tree_rows stages all H rows (H <= CSA_MAX_ROWS = 512 rows of 64
// columns: 128 KiB of shared memory) and runs the H-row program once.
// csa_tree_tiled runs the bh-row program over H tiles of bh rows in
// sequence, rows past H reading as 0 (the TPU kernel's zero padding), and
// keeps the sum of the tile results in a register: the TPU kernel's
// sequential H grid axis and VMEM accumulator become a loop in the block.
// Both wrap mod 2^32 the same way, so any tiling gives the same bits.
//
// Arithmetic is on uint32_t: a left shift of a negative int is undefined
// in C++17, while the TPU kernel's int32 shift wraps.
//
// Bound on the H100 SXM: the stack is read once (4 H N bytes) and the sums
// written once (4 N bytes) at 3.35 TB/s.  The schedule does 8 word
// operations per full adder, about H full adders per column: ~2
// operations per byte read, against the ~5 that 64 INT32 lanes per SM
// (Hopper white paper) x 132 SMs x 1.98 GHz afford per byte of HBM
// traffic, so bytes bound it.  What the design leaves on the table: every
// op reads and writes shared memory (five accesses per full adder), so
// shared-memory traffic, not HBM, is likely to set its pace; the op
// program is re-read from L1 by every block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_FA = 0;

// op: .x kind, .y slot x, .z slot y, .w slot z (negative: the constant 0)
__global__ void __launch_bounds__(1024)
csa_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
           const int4* __restrict__ ops, int n_ops, int result, int bh, int H,
           int N) {
  extern __shared__ uint32_t lane[];  // [bh][blockDim.x]
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const int col = blockIdx.x * B + t;
  if (col >= N) return;
  uint32_t acc = 0u;
  for (int h0 = 0; h0 < H; h0 += bh) {
    for (int r = 0; r < bh; ++r) {
      const int h = h0 + r;
      lane[r * B + t] =
          h < H ? static_cast<uint32_t>(x[(size_t)h * N + col]) : 0u;
    }
    for (int i = 0; i < n_ops; ++i) {
      const int4 op = __ldg(ops + i);
      uint32_t* px = lane + op.y * B + t;
      uint32_t* py = lane + op.z * B + t;
      const uint32_t u = *px;
      const uint32_t v = *py;
      if (op.x == OP_FA) {
        const uint32_t w = op.w < 0 ? 0u : lane[op.w * B + t];
        *px = u ^ v ^ w;
        *py = ((u & v) | (v & w) | (u & w)) << 1;
      } else {
        *px = u + v;
      }
    }
    acc += lane[result * B + t];
  }
  out[col] = static_cast<int32_t>(acc);
}

int launch(const void* x, void* out, const void* ops, int n_ops, int result,
           int bh, int H, int N, int bn, void* stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)bh * bn;
  cudaError_t err = cudaFuncSetAttribute(
      csa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + bn - 1) / bn;
  csa_kernel<<<blocks, bn, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
      static_cast<const int4*>(ops), n_ops, result, bh, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (H,N) int32 -> (N,) int32 on `stream`, all H rows of a block's bn
// columns staged at once; `ops` is the H-row program (n_ops x int4 on the
// device) whose sum ends in slot `result`.  Returns the CUDA error code of
// the launch (0 on success).
int csa_tree_rows(const void* x, void* out, const void* ops, int n_ops,
                  int result, int H, int N, int bn, void* stream) {
  return launch(x, out, ops, n_ops, result, H, H, N, bn, stream);
}

// The same sums over H tiles of bh rows in sequence; `ops` is the bh-row
// program.
int csa_tree_tiled(const void* x, void* out, const void* ops, int n_ops,
                   int result, int bh, int H, int N, int bn, void* stream) {
  return launch(x, out, ops, n_ops, result, bh, H, N, bn, stream);
}

const char* csa_tree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
