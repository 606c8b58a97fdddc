// csa_tree: the shared-memory interpreter of the DCIM macro's carry-save
// adder-tree schedule (paper Fig. 4) on Hopper, for tall whole-row stacks.
//
// Replaces the Pallas TPU kernel csa_tree_pallas (_csa_kernel) of
// repro/kernels/csa_tree/kernel.py for CSA_REG_ROWS < H <= CSA_MAX_ROWS
// (129..512 rows).  Stacks of up to 128 rows, and the tiled route, run the
// register kernel generated per row count from csa_tree_reg.cu.in; this
// one serves the rows whose lanes do not fit in registers.
//
// What it computes: out[n] = sum_h x[h][n] for an (H, N) int32 operand
// stack, as 32-bit words that wrap mod 2^32 (JAX int32 wraps the same
// way), by executing the reduction schedule of the synthesized adder tree:
// 4-2 compressors as two chained full adders on XOR/AND/OR/shift, level by
// level, then a final ripple add.  The schedule is the thing being ported
// (it mirrors the netlist of repro_torch/core/csa.py), so the kernel runs
// it op for op instead of adding the column.
//
// Design.  A 512-lane unroll per thread would spill past Hopper's 255
// registers, so the host builds the schedule once per row count as a small
// op program (build_schedule in repro_torch/kernels/csa_tree/ref.py) and
// the kernel interprets it.  An op is four ints (kind, x, y, z) on lane
// slots:
//   FA:  slot x <- x ^ y ^ z,  slot y <- maj(x, y, z) << 1   (z < 0 reads 0)
//   ADD: slot x <- x + y
// Outputs overwrite input slots, so the program needs no more slots than
// rows.  Each thread owns one column; its H lanes live in shared memory as
// lane[slot][thread], so a warp's 32 accesses to one slot hit 32 banks, and
// no thread reads another's column: the kernel has no barrier.  All threads
// run the same op at the same time, so the op fetch is one broadcast load
// and the branch on its kind never diverges.  512 rows of 64 columns take
// 128 KiB of shared memory.
//
// Arithmetic is on uint32_t: a left shift of a negative int is undefined
// in C++17, while the TPU kernel's int32 shift wraps.
//
// Bound on the H100 SXM: the stack is read once (4 H N bytes) and the sums
// written once (4 N bytes) at 3.35 TB/s.  What the design leaves on the
// table: every op reads and writes shared memory (five accesses per full
// adder, about 20 instructions), and the staging loads and the program do
// not overlap within a block, so it runs well above the bytes bound.  No
// main-path shape reaches it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_FA = 0;

// op: .x kind, .y slot x, .z slot y, .w slot z (negative: the constant 0)
__global__ void __launch_bounds__(1024)
csa_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
           const int4* __restrict__ ops, int n_ops, int result, int H,
           int N) {
  extern __shared__ uint32_t lane[];  // [H][blockDim.x]
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const int col = blockIdx.x * B + t;
  if (col >= N) return;
  for (int h = 0; h < H; ++h)
    lane[h * B + t] = static_cast<uint32_t>(x[(size_t)h * N + col]);
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
  out[col] = static_cast<int32_t>(lane[result * B + t]);
}

}  // namespace

extern "C" {

// (H,N) int32 -> (N,) int32 on `stream`, all H rows of a block's bn
// columns staged at once; `ops` is the H-row program (n_ops x int4 on the
// device) whose sum ends in slot `result`.  Returns the CUDA error code of
// the launch (0 on success).
int csa_tree_rows(const void* x, void* out, const void* ops, int n_ops,
                  int result, int H, int N, int bn, void* stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)H * bn;
  cudaError_t err = cudaFuncSetAttribute(
      csa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + bn - 1) / bn;
  csa_kernel<<<blocks, bn, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
      static_cast<const int4*>(ops), n_ops, result, H, N);
  return static_cast<int>(cudaGetLastError());
}

const char* csa_tree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
