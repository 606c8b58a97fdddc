// lattice_rollup: the compiler's float64 PPA roll-up of a whole design
// lattice on Hopper, for a stack of S specs at once.
//
// Replaces the XLA kernel of repro/core/batched.py:_eval_kernel (A1),
// vmapped over the specs of a group at repro/core/engine.py:84.  It was
// not a Pallas kernel: XLA fused the gathers and adds.  The port's plain
// version is core/batched.py:_eval_kernel, one eager torch op per line.
//
// What it computes, for each spec s and lattice point p, from the shared
// int64 gather indices mem_i, mm_i, csa_j, ofu_j, prec_j (n,) and the
// spec's tables (rows of (S, len) arrays):
//   mac_base = t_wl_mm[mm] + csa_crit[csa]       ofu_base = t_ofu[ofu]
//   the five gathered area terms a_array[mem], a_mult[mm], a_tree[csa],
//   a_ofu[ofu], a_align[prec];
//   area = (((((((a_array + a_mult) + a_tree) + a_sa) + a_ofu) + a_align)
//          + a_drv) * apr
//   and for each mode m
//   e_cycle[m] = ((((((((0.0 + e_wl) + e_mm[mm]) + e_tree[csa]) + e_sa)
//                + e_ofu[m, ofu]) + e_align[m, prec]) + e_bl) * eps_fj)
//                * escale
// with a_sa, a_drv, apr, e_wl, e_sa, e_bl, eps_fj, escale the spec's row of
// `consts` (batched._CONST_FIELDS order).
//
// Exactness.  Every output must carry the plain version's bits, which are
// the scalar roll-up's (macro.rollup).  Each step is one IEEE float64
// operation in the plain version's order, written __dadd_rn / __dmul_rn:
// nvcc never contracts these intrinsics into an FMA nor reorders them,
// which is what keeps the bits.  The source is also built with
// -fmad=false (kernels/build.py), a safety net for a plain a * b + c.  The
// leading 0.0 + e_wl stays: it turns a -0.0 into +0.0, as torch's does.
// A negative index counts from the end of its table, as torch's indexing
// does; an index outside the table traps, as torch's device-side index
// assertion does.
//
// Design.  One thread per (spec, point): grid.y is the spec, and each
// block of grid.x walks its points in a grid-stride loop.  A spec's tables
// are a few hundred doubles (the registered lattice: 579 of them, plus 8
// constants and the per-mode OFU and alignment energies), so each block
// stages its spec's rows in shared memory once, and every gather is a
// shared-memory read.  Each thread reads its point's five indices once
// and uses them for every output and mode; each output row is written
// coalesced.  One launch covers a group of specs.
//
// Bound on the H100 SXM: the indices read once, the tables read once and
// (8 + M) float64 outputs per (spec, point) written once at 3.35 TB/s,
// against 8 + 9 M float64 operations per (spec, point): bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks in flight across the specs of a launch: 8 per SM of the H100's
// 132
constexpr int kBlocks = 1056;
constexpr int kTables = 10;
constexpr int kConsts = 8;
constexpr int kOutputs = 8;

}  // namespace

extern "C" {

// The operands of one launch.  Tables, in order: t_wl_mm, csa_crit,
// t_ofu, a_array, a_mult, a_tree, a_ofu, a_align, e_mm, e_tree, each
// (S, tab_len[j]) float64; outputs, in order: mac_base, ofu_base, area,
// a_array, a_mult, a_tree, a_ofu, a_align, each (S, n) float64, and
// e_cycle (S, modes, n).  Every array is contiguous on the device.
struct RollupArgs {
  const int64_t* idx[5];         // mem_i, mm_i, csa_j, ofu_j, prec_j (n,)
  const double* tabs[kTables];
  int64_t tab_len[kTables];
  const double* consts;          // (S, 8)
  const double* e_ofu;           // (S, modes, n_ofu)
  const double* e_align;         // (S, modes, n_align)
  int64_t n_ofu;
  int64_t n_align;
  int64_t n;
  int64_t specs;
  int64_t modes;
  double* out[kOutputs];
  double* e_cycle;
};

}  // extern "C"

namespace {

__device__ __forceinline__ int64_t wrap(int64_t j, int64_t len) {
  if (j < 0) j += len;
  if (j < 0 || j >= len) __trap();
  return j;
}

__global__ void __launch_bounds__(kThreads)
    rollup_kernel(const RollupArgs a) {
  extern __shared__ double smem[];
  const int64_t s = blockIdx.y;

  // stage spec s's rows: the ten tables, the constants, then the per-mode
  // OFU and alignment energies
  int64_t offset[kTables];
  int64_t cursor = 0;
#pragma unroll
  for (int j = 0; j < kTables; ++j) {
    offset[j] = cursor;
    cursor += a.tab_len[j];
  }
  const int64_t c_at = cursor;
  const int64_t ofu_at = c_at + kConsts;
  const int64_t align_at = ofu_at + a.modes * a.n_ofu;
  const int64_t total = align_at + a.modes * a.n_align;
#pragma unroll
  for (int j = 0; j < kTables; ++j)
    for (int64_t e = threadIdx.x; e < a.tab_len[j]; e += kThreads)
      smem[offset[j] + e] = a.tabs[j][s * a.tab_len[j] + e];
  for (int64_t e = threadIdx.x; e < total - c_at; e += kThreads) {
    const int64_t f = e - kConsts;
    smem[c_at + e] =
        e < kConsts ? a.consts[s * kConsts + e]
        : f < a.modes * a.n_ofu
            ? a.e_ofu[s * a.modes * a.n_ofu + f]
            : a.e_align[s * a.modes * a.n_align + (f - a.modes * a.n_ofu)];
  }
  __syncthreads();

  const double* c = smem + c_at;
  const double apr = c[0], a_sa = c[1], a_drv = c[2], e_wl = c[3],
               e_sa = c[4], e_bl = c[5], eps_fj = c[6], escale = c[7];
  const int64_t row = s * a.n;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < a.n; p += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t mem = a.idx[0][p], mm = a.idx[1][p], csa = a.idx[2][p],
                  ofu = a.idx[3][p], prec = a.idx[4][p];
    const double t_wl_mm = smem[offset[0] + wrap(mm, a.tab_len[0])],
                 csa_crit = smem[offset[1] + wrap(csa, a.tab_len[1])],
                 t_ofu = smem[offset[2] + wrap(ofu, a.tab_len[2])],
                 a_array = smem[offset[3] + wrap(mem, a.tab_len[3])],
                 a_mult = smem[offset[4] + wrap(mm, a.tab_len[4])],
                 a_tree = smem[offset[5] + wrap(csa, a.tab_len[5])],
                 a_ofu = smem[offset[6] + wrap(ofu, a.tab_len[6])],
                 a_align = smem[offset[7] + wrap(prec, a.tab_len[7])],
                 e_mm = smem[offset[8] + wrap(mm, a.tab_len[8])],
                 e_tree = smem[offset[9] + wrap(csa, a.tab_len[9])];

    a.out[0][row + p] = __dadd_rn(t_wl_mm, csa_crit);
    a.out[1][row + p] = t_ofu;
    double placed = __dadd_rn(a_array, a_mult);
    placed = __dadd_rn(placed, a_tree);
    placed = __dadd_rn(placed, a_sa);
    placed = __dadd_rn(placed, a_ofu);
    placed = __dadd_rn(placed, a_align);
    placed = __dadd_rn(placed, a_drv);
    a.out[2][row + p] = __dmul_rn(placed, apr);
    a.out[3][row + p] = a_array;
    a.out[4][row + p] = a_mult;
    a.out[5][row + p] = a_tree;
    a.out[6][row + p] = a_ofu;
    a.out[7][row + p] = a_align;

    const int64_t oj = wrap(ofu, a.n_ofu), pj = wrap(prec, a.n_align);
    for (int64_t m = 0; m < a.modes; ++m) {
      double e = __dadd_rn(0.0, e_wl);
      e = __dadd_rn(e, e_mm);
      e = __dadd_rn(e, e_tree);
      e = __dadd_rn(e, e_sa);
      e = __dadd_rn(e, smem[ofu_at + m * a.n_ofu + oj]);
      e = __dadd_rn(e, smem[align_at + m * a.n_align + pj]);
      e = __dadd_rn(e, e_bl);
      a.e_cycle[(s * a.modes + m) * a.n + p] =
          __dmul_rn(__dmul_rn(e, eps_fj), escale);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block stages for `args` (bytes).
int64_t lattice_rollup_smem_bytes(const RollupArgs* args) {
  int64_t total = kConsts + args->modes * (args->n_ofu + args->n_align);
  for (int j = 0; j < kTables; ++j) total += args->tab_len[j];
  return total * static_cast<int64_t>(sizeof(double));
}

// The roll-up of `args` in one launch on `stream`.  Returns the CUDA error
// code (0 on success; cudaErrorInvalidValue for more than 65,535 specs, a
// negative count, or tables larger than a block's shared memory).
int lattice_rollup(const RollupArgs* args, cudaStream_t stream) {
  const RollupArgs& a = *args;
  if (a.n < 0 || a.specs < 0 || a.specs > 65535 || a.modes < 0 ||
      a.n_ofu < 1 || a.n_align < 1)
    return cudaErrorInvalidValue;
  for (int j = 0; j < kTables; ++j)
    if (a.tab_len[j] < 1) return cudaErrorInvalidValue;
  if (a.n == 0 || a.specs == 0) return cudaSuccess;
  const int64_t smem = lattice_rollup_smem_bytes(args);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rollup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t per_spec = (kBlocks + a.specs - 1) / a.specs;
  const int64_t need = (a.n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(need < per_spec ? need : per_spec),
                  static_cast<unsigned>(a.specs));
  rollup_kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

const char* lattice_rollup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
