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
// block of grid.x takes one contiguous range of the points, which its
// threads walk 256 apart.  The grid is persistent and balanced: as many
// blocks as the card holds at once (an occupancy query), shared among the
// specs of the launch, and the ranges are whole 256-point tiles sized so
// that every block walks the same number of tiles (the last block fewer),
// so no block starts a tile after the others are done.  A spec's tables
// are a few hundred doubles (the registered lattice: 579 of them, plus 8
// constants and the per-mode OFU and alignment energies), so each block
// stages its spec's rows in shared memory once, every thread loading its
// share into registers first so that the loads are in flight together;
// every gather is then a shared-memory read.  A thread's first point's
// five indices are loaded before the staging, and each next point's
// before the current one is computed, so their latency hides behind work.
// The tables' offsets in shared memory are computed once on the host and
// read from the kernel's parameters, so the kernel keeps no local array
// and spills nothing.  Each output row is written coalesced, with
// streaming stores (the outputs are read back by the host, not by a later
// kernel).  One launch covers a group of specs.
//
// Bound on the H100 SXM: the indices read once, the tables read once and
// (8 + M) float64 outputs per (spec, point) written once at 3.35 TB/s,
// against 8 + 9 M float64 operations per (spec, point): bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks per SM the register budget is sized for (at most 85 registers a
// thread)
constexpr int kMinBlocks = 3;
constexpr int kTables = 10;
constexpr int kConsts = 8;
constexpr int kOutputs = 8;
constexpr int kIndices = 5;
// staged doubles a thread holds in registers at once
constexpr int kStage = 4;

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

// Where a block stages its spec's rows in shared memory (doubles): the ten
// tables, the constants, then the per-mode OFU and alignment energies.
struct Layout {
  int tab_off[kTables];
  int tab_len[kTables];
  int c_at;
  int ofu_at;
  int align_at;
  int total;
  int modes;
  int n_ofu;
  int n_align;
};

__device__ __forceinline__ int64_t wrap(int64_t j, int64_t len) {
  if (j < 0) j += len;
  if (j < 0 || j >= len) __trap();
  return j;
}

// Staged double e of spec s.  The table is picked by comparisons with
// constant indices into the parameters, so nothing is indexed at run time.
__device__ __forceinline__ double staged(const RollupArgs& a,
                                         const Layout& L, int64_t s, int e) {
  if (e >= L.c_at) {
    const int f = e - L.c_at;
    if (f < kConsts) return a.consts[s * kConsts + f];
    const int g = f - kConsts;
    const int per_ofu = L.modes * L.n_ofu;
    return g < per_ofu
               ? a.e_ofu[s * per_ofu + g]
               : a.e_align[s * L.modes * L.n_align + (g - per_ofu)];
  }
  const double* src = a.tabs[0];
  int len = L.tab_len[0], off = L.tab_off[0];
#pragma unroll
  for (int j = 1; j < kTables; ++j)
    if (e >= L.tab_off[j]) {
      src = a.tabs[j];
      len = L.tab_len[j];
      off = L.tab_off[j];
    }
  return src[s * len + (e - off)];
}

__device__ __forceinline__ void load_indices(const RollupArgs& a, int64_t p,
                                             int64_t end,
                                             int64_t (&raw)[kIndices]) {
#pragma unroll
  for (int f = 0; f < kIndices; ++f) raw[f] = p < end ? a.idx[f][p] : 0;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rollup_kernel(const RollupArgs a, const Layout L, int64_t per_block) {
  extern __shared__ double smem[];
  const int64_t s = blockIdx.y;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = min(begin + per_block, a.n);
  int64_t p = begin + threadIdx.x;

  // this thread's first point's indices, in flight during the staging
  int64_t raw[kIndices];
  load_indices(a, p, end, raw);

  for (int base = 0; base < L.total; base += kThreads * kStage) {
    double v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      v[u] = e < L.total ? staged(a, L, s, e) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      if (e < L.total) smem[e] = v[u];
    }
  }
  __syncthreads();

  const double* c = smem + L.c_at;
  const double apr = c[0], a_sa = c[1], a_drv = c[2], e_wl = c[3],
               e_sa = c[4], e_bl = c[5], eps_fj = c[6], escale = c[7];
  const int64_t row = s * a.n;
  for (; p < end; p += kThreads) {
    const int64_t mem = raw[0], mm = raw[1], csa = raw[2], ofu = raw[3],
                  prec = raw[4];
    const double t_wl_mm = smem[L.tab_off[0] + wrap(mm, L.tab_len[0])],
                 csa_crit = smem[L.tab_off[1] + wrap(csa, L.tab_len[1])],
                 t_ofu = smem[L.tab_off[2] + wrap(ofu, L.tab_len[2])],
                 a_array = smem[L.tab_off[3] + wrap(mem, L.tab_len[3])],
                 a_mult = smem[L.tab_off[4] + wrap(mm, L.tab_len[4])],
                 a_tree = smem[L.tab_off[5] + wrap(csa, L.tab_len[5])],
                 a_ofu = smem[L.tab_off[6] + wrap(ofu, L.tab_len[6])],
                 a_align = smem[L.tab_off[7] + wrap(prec, L.tab_len[7])],
                 e_mm = smem[L.tab_off[8] + wrap(mm, L.tab_len[8])],
                 e_tree = smem[L.tab_off[9] + wrap(csa, L.tab_len[9])];
    const int64_t oj = wrap(ofu, L.n_ofu), pj = wrap(prec, L.n_align);
    // the next point's indices, in flight while this one is written
    load_indices(a, p + kThreads, end, raw);

    __stcs(a.out[0] + row + p, __dadd_rn(t_wl_mm, csa_crit));
    __stcs(a.out[1] + row + p, t_ofu);
    double placed = __dadd_rn(a_array, a_mult);
    placed = __dadd_rn(placed, a_tree);
    placed = __dadd_rn(placed, a_sa);
    placed = __dadd_rn(placed, a_ofu);
    placed = __dadd_rn(placed, a_align);
    placed = __dadd_rn(placed, a_drv);
    __stcs(a.out[2] + row + p, __dmul_rn(placed, apr));
    __stcs(a.out[3] + row + p, a_array);
    __stcs(a.out[4] + row + p, a_mult);
    __stcs(a.out[5] + row + p, a_tree);
    __stcs(a.out[6] + row + p, a_ofu);
    __stcs(a.out[7] + row + p, a_align);

    for (int m = 0; m < L.modes; ++m) {
      double e = __dadd_rn(0.0, e_wl);
      e = __dadd_rn(e, e_mm);
      e = __dadd_rn(e, e_tree);
      e = __dadd_rn(e, e_sa);
      e = __dadd_rn(e, smem[L.ofu_at + m * L.n_ofu + oj]);
      e = __dadd_rn(e, smem[L.align_at + m * L.n_align + pj]);
      e = __dadd_rn(e, e_bl);
      __stcs(a.e_cycle + (s * L.modes + m) * a.n + p,
             __dmul_rn(__dmul_rn(e, eps_fj), escale));
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
  int device = 0, limit = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  // the shared-memory layout (it fits in int: smem <= limit)
  Layout L;
  int cursor = 0;
  for (int j = 0; j < kTables; ++j) {
    L.tab_off[j] = cursor;
    L.tab_len[j] = static_cast<int>(a.tab_len[j]);
    cursor += L.tab_len[j];
  }
  L.c_at = cursor;
  L.ofu_at = L.c_at + kConsts;
  L.align_at = L.ofu_at + static_cast<int>(a.modes * a.n_ofu);
  L.total = L.align_at + static_cast<int>(a.modes * a.n_align);
  L.modes = static_cast<int>(a.modes);
  L.n_ofu = static_cast<int>(a.n_ofu);
  L.n_align = static_cast<int>(a.n_align);

  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rollup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rollup_kernel, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  // one wave of blocks shared among the specs, each walking the same
  // number of whole tiles
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t tiles = (a.n + kThreads - 1) / kThreads;
  const int64_t most = resident / a.specs > 0 ? resident / a.specs : 1;
  const int64_t walk = (tiles + most - 1) / most;
  const int64_t blocks = (tiles + walk - 1) / walk;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(a.specs));
  rollup_kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      a, L, walk * kThreads);
  return cudaGetLastError();
}

const char* lattice_rollup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
