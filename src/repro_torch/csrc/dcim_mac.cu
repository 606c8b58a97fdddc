// dcim_mac: the DCIM macro's int8 MAC array (paper Fig. 1) on Hopper.
//
// Replaces the Pallas TPU kernels of repro/kernels/dcim_mac/kernel.py:
//   dcim_matmul_int_pallas            (_int_kernel)           -> KIND OUT_I32
//   dcim_matmul_int_pipelined_pallas  (_int_pipelined_kernel) -> KIND OUT_I32
//   dcim_matmul_pallas                (_mac_kernel)           -> OUT_F32/BF16
//   dcim_matmul_pipelined_pallas      (_mac_pipelined_kernel) -> OUT_F32/BF16
// The grid and pipelined TPU variants compute the same bits; on the card
// the route is chosen by shape and alignment (kernels/dcim_mac/plan.py):
// dcim_mac_tma (route `pipelined`) where TMA can describe the operands,
// dcim_mac_grid (route `grid`) for the rest.
//
// What it computes: C[m][n] = sum_k A[m][k] * W[k][n] with A (M,K) int8 and
// W (K,N) int8, both row-major, accumulated exactly in int32 (wrapping, as
// the TPU kernel's int32 accumulator does).  KIND OUT_I32 stores C as
// int32; OUT_F32 and OUT_BF16 apply the dequant epilogue
//   out[m][n] = (float)C[m][n] * (a_scale[m] * w_scale[n])
// (the scale product first, as the TPU kernel does) and store float32, or
// bfloat16 rounded to nearest even.  No add follows a multiply, so there is
// nothing for FMA contraction to change.
//
// Bound on the H100 SXM (NVIDIA data sheet, dense): int8 work is 2 M K N
// operations at 1,979 TOPS against M K + K N + 4 M N bytes at 3.35 TB/s.
// At the qwen3-4b GEMMs (M = 256 tokens) the bytes bound, but only just:
// 2 M = 512 operations per weight byte against the card's ridge of ~590.
// mlp_up (256 x 2560 x 19456) needs 12.9 us of tensor-core work at the
// full rate and 21 us of memory traffic, so the kernel has to run the
// tensor cores near their full rate AND keep HBM busy.
//
// The TMA kernel (dcim_mac_tma_kernel) is built for that:
//
// * Each weight byte comes from HBM once.  A block owns a 128-column strip
//   of W and ALL tokens of a 256-token strip of A (M > 256 is cut into
//   256-token strips); A, 655 KB for wq at seq 256, is served from L2 to
//   every strip.
// * Tensor cores at the full rate: wgmma.mma_async m64n128k32 s32.s8.s8,
//   both operands from shared memory, one commit group per stage with the
//   previous one still in flight.  Two consumer warpgroups own 128 tokens
//   each (two m64 tiles, 128 int32 accumulators a thread); a tile whose
//   tokens all lie past M issues no wgmma (the branch sits outside the
//   stage loop: a wgmma under a branch inside it makes ptxas serialize
//   the pipeline).
// * Two TMA rings, each stage guarded by a `full` mbarrier (TMA
//   transaction bytes) and an `empty` one: DEPTH (2-4) stages of A (256 x
//   128 bytes) released by the consumers when their wgmma is done, and
//   W_BUFS stages of raw W (128 x 128 bytes) released by the transposers
//   as soon as they have read them.  One producer thread issues every
//   load as soon as its buffer is free, polling both rings, so W runs
//   ahead of A.  Both boxes use the 128-byte swizzle.
// * W is transposed once per stage in shared memory.  s8 wgmma reads both
//   operands K-major only, and W is N-major.  Three transposer warps read
//   a raw W stage (a lane reads one word of each of 16 K rows: 32 lanes a
//   whole 128-byte row, no bank conflict), transpose 4 x 4 byte blocks
//   with __byte_perm and write 16-byte K chunks into a WT_BUFS ring in
//   the 128-byte-swizzled K-major layout the wgmma descriptor reads (each
//   lane's words are byte-rotated by (lane >> 1) & 3 on the way in, so
//   the eight lanes of a store phase hit eight distinct chunks), then
//   fence.proxy.async for the wgmma's async proxy.  The transpose runs
//   beside the consumers' wgmma, off their critical path.  Swapping the
//   operands (C^T = W^T A^T with W^T in registers) was not taken: the
//   register fragments would need the same byte transpose inside the
//   consumers.
// * Fill 132 SMs: narrow GEMMs have few strips (wk and wv: 8), so K is
//   split over a cluster of S blocks (S in 1, 2, 4, 8; mac_plan in
//   plan.py).  Each block writes its int32 partial tile into its own (by
//   then idle) ring memory; after a cluster barrier every block sums 1/S
//   of the tile across the cluster through distributed shared memory (8 S
//   loads in flight a thread) and applies the epilogue to that full int32
//   sum.  int32 addition wraps and is associative, so any order gives the
//   same bits, and no partial goes through HBM.
// * Registers: setmaxnreg gives warpgroup 0 (producer, transposers) 96
//   and the consumers 200 a thread (launch bound 384 threads, one block
//   per SM: 168 at entry, and 96 + 2 x 200 <= 3 x 168).
// * The epilogue stores from registers (two adjacent columns per store).
//
// What bounds it on the card (probes/mac_tma.py, H100 SXM): the TMA
// streams.  With the transposes and the wgmma cut out, a block still
// moves one stage in about 1-2 us, and the W stream alone reaches about
// 1.2-2 TB/s; the transposes and the wgmma add 20-40% on top, the K
// split's reduction 10-25%.  See PERF.md for the numbers.
//
// Shared memory: 1 KB alignment slack, DEPTH x 32 KB of A, 2 x W_BUFS x
// 16 KB of raw and transposed W, and the mbarriers: 230,560 bytes at
// DEPTH 4, within the 232,448 a block may use (kernels/tiles.py:
// smem_bytes counts the same).  The TMA descriptors are encoded on the
// host per call through cuTensorMapEncodeTiled, reached by
// cudaGetDriverEntryPoint so that no -lcuda is needed, and passed as
// __grid_constant__ parameters.
//
// The grid kernel (dcim_mac_grid_kernel) takes what TMA
// cannot describe: rows whose byte length is not a multiple of 16, an
// operand that does not start on a 16-byte boundary, and strips shorter
// than one wgmma tile (64 tokens).  One block of 4 warps computes a 64 x
// 64 tile with mma.sync m16n8k32 s8.s8.s32; it stages 128-deep K slices
// in swizzled shared memory (W transposed on the way in with __byte_perm)
// with a one-stage register prefetch, and reads bytes past the ragged
// edges as 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

// Two adjacent outputs (m, n) and (m, n + 1) of a row-major (M, N) output.
template <int KIND>
__device__ __forceinline__ void store_pair(void* __restrict__ out,
                                           const float* __restrict__ a_scale,
                                           const float* __restrict__ w_scale,
                                           int N, int m, int n, int c0,
                                           int c1) {
  const size_t o = (size_t)m * N + n;
  if constexpr (KIND == OUT_I32) {
    *reinterpret_cast<int2*>(static_cast<int32_t*>(out) + o) =
        make_int2(c0, c1);
  } else {
    const float sa = a_scale[m];
    const float f0 = (float)c0 * (sa * w_scale[n]);
    const float f1 = (float)c1 * (sa * w_scale[n + 1]);
    if constexpr (KIND == OUT_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
          make_float2(f0, f1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(
          static_cast<__nv_bfloat16*>(out) + o) = __floats2bfloat162_rn(f0, f1);
    }
  }
}

// ---------------------------------------------------------------------------
// The TMA / wgmma kernel (route `pipelined`)
// ---------------------------------------------------------------------------

namespace tma {

constexpr int BM = 256;               // tokens of a strip
constexpr int BN = 128;               // W columns of a strip
constexpr int BK = 128;               // K depth of one stage
constexpr int CONSUMERS = 2;          // warpgroups 1, 2: 128 tokens each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int CONSUMER_THREADS = 128 * CONSUMERS;
constexpr int TRANSPOSER_WARPS = 3;   // warps 1-3 of warpgroup 0
constexpr int TRANSPOSERS = 32 * TRANSPOSER_WARPS;
constexpr int A_STAGE = BM * BK;      // bytes
constexpr int W_STAGE = BK * BN;
constexpr int W_BUFS = 3;             // raw W stages (DEPTH: A stages)
constexpr int WT_BUFS = W_BUFS;       // transposed W buffers
constexpr int ALIGN = 1024;           // the 128-byte swizzle's atom
constexpr int ACC = 64;               // int32 accumulators of one m64n128

__host__ __device__ constexpr int smem_bytes(int depth) {
  return ALIGN + depth * A_STAGE + (W_BUFS + WT_BUFS) * W_STAGE +
         8 * (2 * depth + 2 * W_BUFS + 2 * WT_BUFS);
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Whether the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
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

// One 2-D box of a tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d += A (64 x 32, K-major) * B (128 x 32, K-major), int8 -> int32.
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The 16 K rows 16c .. 16c + 15 of a raw W stage (128 K rows of 128 N
// bytes, row-major, 16-byte chunks in the 128-byte swizzle as TMA writes
// them) as lane `lane` holds them: word `lane` of each row (N columns
// 4 lane .. 4 lane + 3; 32 lanes read a whole row, no bank conflict), each
// rotated right by `q` = (lane >> 1) & 3 bytes (`rot`), so that byte b
// holds column 4 lane + ((b + q) & 3).
__device__ __forceinline__ void load_chunk(uint32_t (&r)[16],
                                           const uint32_t* __restrict__ raw,
                                           int c, int lane, uint32_t rot) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    r[i] = __byte_perm(
        raw[(16 * c + i) * (BN / 4) + ((((lane >> 2) ^ (i & 7)) << 2) |
                                       (lane & 3))],
        0, rot);
}

// Writes the rows of load_chunk as 16-byte K chunk c of the four columns
// n = 4 lane + ((j + q) & 3), j = 0..3, of the K-major transposed buffer,
// at physical chunk c ^ (n & 7) (the 128-byte swizzle): 4 x 4 byte blocks
// transposed with __byte_perm.  The rotation by q makes the eight lanes of
// a store phase hit eight distinct chunks.
__device__ __forceinline__ void store_chunk(const uint32_t (&r)[16],
                                            uint8_t* __restrict__ dst, int c,
                                            int lane) {
  const int q = (lane >> 1) & 3;
  uint32_t v[4][4];   // v[j][qq]: byte j of rows 4 qq .. 4 qq + 3
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    const uint32_t r0 = r[4 * qq], r1 = r[4 * qq + 1];
    const uint32_t r2 = r[4 * qq + 2], r3 = r[4 * qq + 3];
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    v[0][qq] = __byte_perm(t0, t1, 0x5410);
    v[1][qq] = __byte_perm(t0, t1, 0x7632);
    v[2][qq] = __byte_perm(t2, t3, 0x5410);
    v[3][qq] = __byte_perm(t2, t3, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * lane + ((j + q) & 3);
    *reinterpret_cast<uint4*>(dst + n * BK + ((c ^ (n & 7)) << 4)) =
        make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
  }
}

// A transposer warp's chunks of one stage: c = w, w + 3, w + 6 (< 8) for
// transposer warp w = 0..2, the next chunk's rows loaded before the
// current one is stored.
__device__ __forceinline__ void transpose_stage(const uint32_t* __restrict__ raw,
                                                uint8_t* __restrict__ dst,
                                                int w, int lane,
                                                uint32_t rot) {
  uint32_t cur[16], nxt[16];
  load_chunk(cur, raw, w, lane, rot);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int c = w + TRANSPOSER_WARPS * i;
    if (c >= BK / 16) break;
    const bool more = c + TRANSPOSER_WARPS < BK / 16;
    if (more) load_chunk(nxt, raw, c + TRANSPOSER_WARPS, lane, rot);
    store_chunk(cur, dst, c, lane);
    if (more) {
#pragma unroll
      for (int k = 0; k < 16; ++k) cur[k] = nxt[k];
    }
  }
}

// A consumer warpgroup's walk over its T stages: `a` is its first token's
// row in A buffer 0, TILES (0, 1 or 2) of its two m64 tiles hold tokens
// < M.  The caller branches on TILES outside the loop: a wgmma under a
// branch inside it would make ptxas serialize the wgmma pipeline.
template <int TILES, int DEPTH>
__device__ __forceinline__ void consume(int (&acc0)[ACC], int (&acc1)[ACC],
                                        int T, const uint8_t* a,
                                        const uint8_t* wt, uint32_t a_full0,
                                        uint32_t a_empty0, uint32_t wt_full0,
                                        uint32_t wt_empty0) {
  for (int t = 0; t < T; ++t) {
    const int s = t % DEPTH, b = t % WT_BUFS;
    mbar_wait(a_full0 + 8 * s, (t / DEPTH) & 1);
    mbar_wait(wt_full0 + 8 * b, (t / WT_BUFS) & 1);
    if constexpr (TILES > 0) {
      const uint32_t a_s = smem_u32(a + s * A_STAGE);
      const uint32_t b_s = smem_u32(wt + b * W_STAGE);
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t db = sw128_desc(b_s + 32 * kk);
        wgmma_s8(acc0, sw128_desc(a_s + 32 * kk), db);
        if constexpr (TILES > 1)
          wgmma_s8(acc1, sw128_desc(a_s + 64 * BK + 32 * kk), db);
      }
      wgmma_commit();
      // at most stage t's group stays in flight: stage t - 1's are done
      wgmma_wait<1>();
      fence_acc(acc0);
      fence_acc(acc1);
    }
    if (t > 0) {
      mbar_arrive(a_empty0 + 8 * ((t - 1) % DEPTH));
      mbar_arrive(wt_empty0 + 8 * ((t - 1) % WT_BUFS));
    }
  }
  if constexpr (TILES > 0) {
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
  }
}

// One m64n128 accumulator tile of a consumer thread, rows from `row`.
template <int KIND>
__device__ __forceinline__ void store_tile(const int (&d)[ACC], void* out,
                                           const float* a_scale,
                                           const float* w_scale, int M, int N,
                                           int row, int n0) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r0 = row + 16 * (t >> 5) + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int m = r0 + 8 * hv, n = c0 + 8 * j;
      if (m < M && n < N)
        store_pair<KIND>(out, a_scale, w_scale, N, m, n, d[4 * j + 2 * hv],
                         d[4 * j + 2 * hv + 1]);
    }
  }
}

template <int KIND, int DEPTH>
__global__ void __launch_bounds__(THREADS, 1)
dcim_mac_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const float* __restrict__ a_scale,
                    const float* __restrict__ w_scale, void* __restrict__ out,
                    int M, int K, int N, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((ALIGN - raw_s % ALIGN) % ALIGN);
  uint8_t* a_ring = smem;                          // DEPTH A stages
  uint8_t* w_ring = a_ring + DEPTH * A_STAGE;      // W_BUFS raw W stages
  uint8_t* wt = w_ring + W_BUFS * W_STAGE;         // WT_BUFS K-major W
  const uint32_t a_full0 = smem_u32(wt + WT_BUFS * W_STAGE);
  const uint32_t a_empty0 = a_full0 + 8 * DEPTH;
  const uint32_t w_full0 = a_empty0 + 8 * DEPTH;
  const uint32_t w_empty0 = w_full0 + 8 * W_BUFS;
  const uint32_t wt_full0 = w_empty0 + 8 * W_BUFS;
  const uint32_t wt_empty0 = wt_full0 + 8 * WT_BUFS;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // this block's stages of K: floor(z T / S) on (plan.py's stage_ranges)
  const int total = (K + BK - 1) / BK;
  const int t_begin = (int)((long long)blockIdx.z * total / splits);
  const int T = (int)((long long)(blockIdx.z + 1) * total / splits) - t_begin;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(a_full0 + 8 * s, 1);
      mbar_init(a_empty0 + 8 * s, CONSUMER_THREADS);
    }
#pragma unroll
    for (int b = 0; b < W_BUFS; ++b) {
      mbar_init(w_full0 + 8 * b, 1);
      mbar_init(w_empty0 + 8 * b, TRANSPOSERS);
    }
#pragma unroll
    for (int b = 0; b < WT_BUFS; ++b) {
      mbar_init(wt_full0 + 8 * b, TRANSPOSERS);
      mbar_init(wt_empty0 + 8 * b, CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n");
    if (warp == 0) {
      // producer: one thread issues each stage's A and W loads as soon as
      // their buffers are free, the two rings independently
      if (lane == 0) {
        int ta = 0, tw = 0;
        while (ta < T || tw < T) {
          if (tw < T && (tw < W_BUFS ||
                         mbar_test(w_empty0 + 8 * (tw % W_BUFS),
                                   ((tw / W_BUFS) & 1) ^ 1))) {
            const uint32_t bar = w_full0 + 8 * (tw % W_BUFS);
            mbar_expect_tx(bar, W_STAGE);
            tma_load(smem_u32(w_ring + (tw % W_BUFS) * W_STAGE), &w_map, bar,
                     n0, (t_begin + tw) * BK);
            ++tw;
          }
          if (ta < T && (ta < DEPTH ||
                         mbar_test(a_empty0 + 8 * (ta % DEPTH),
                                   ((ta / DEPTH) & 1) ^ 1))) {
            const uint32_t bar = a_full0 + 8 * (ta % DEPTH);
            mbar_expect_tx(bar, A_STAGE);
            tma_load(smem_u32(a_ring + (ta % DEPTH) * A_STAGE), &a_map, bar,
                     (t_begin + ta) * BK, m0);
            ++ta;
          }
        }
      }
    } else {
      // transposers: raw W buffer t % W_BUFS -> K-major buffer t % WT_BUFS
      const int q = (lane >> 1) & 3;
      const uint32_t rot = q | ((q + 1) & 3) << 4 | ((q + 2) & 3) << 8 |
                           ((q + 3) & 3) << 12;
      for (int t = 0; t < T; ++t) {
        const int s = t % W_BUFS, b = t % WT_BUFS;
        mbar_wait(w_full0 + 8 * s, (t / W_BUFS) & 1);
        if (t >= WT_BUFS)
          mbar_wait(wt_empty0 + 8 * b, ((t / WT_BUFS) & 1) ^ 1);
        transpose_stage(
            reinterpret_cast<const uint32_t*>(w_ring + s * W_STAGE),
            wt + b * W_STAGE, warp - 1, lane, rot);
        // the generic-proxy stores must be visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(wt_full0 + 8 * b);
        mbar_arrive(w_empty0 + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int row0 = (wg - 1) * 128;          // this warpgroup's tokens
    int acc0[ACC], acc1[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc0[i] = acc1[i] = 0;
    // how many of the warpgroup's two m64 tiles hold tokens < M
    if (m0 + row0 + 64 < M)
      consume<2, DEPTH>(acc0, acc1, T, a_ring + row0 * BK, wt, a_full0,
                        a_empty0, wt_full0, wt_empty0);
    else if (m0 + row0 < M)
      consume<1, DEPTH>(acc0, acc1, T, a_ring + row0 * BK, wt, a_full0,
                        a_empty0, wt_full0, wt_empty0);
    else
      consume<0, DEPTH>(acc0, acc1, T, a_ring + row0 * BK, wt, a_full0,
                        a_empty0, wt_full0, wt_empty0);

    if (splits == 1) {
      store_tile<KIND>(acc0, out, a_scale, w_scale, M, N, m0 + row0, n0);
      store_tile<KIND>(acc1, out, a_scale, w_scale, M, N, m0 + row0 + 64, n0);
    } else {
      // every consumer has finished with the ring: it holds the partial
      // tile now, accumulator i of consumer thread c at word i * 256 + c
      asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMER_THREADS) : "memory");
      uint32_t* part = reinterpret_cast<uint32_t*>(smem);
      const int c = tid - 128;
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        part[i * CONSUMER_THREADS + c] = (uint32_t)acc0[i];
        part[(ACC + i) * CONSUMER_THREADS + c] = (uint32_t)acc1[i];
      }
    }
  }

  if (splits > 1) {
    cluster_sync();   // every partial of the cluster is written
    if (wg > 0) {
      // this block sums accumulators [rank * 128 / S, (rank + 1) * 128 / S)
      // of every consumer thread over the cluster and stores them, eight
      // at a time: the 8 S loads of a batch are in flight together
      uint32_t rank;
      asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
      const int c = tid - 128, per = 2 * ACC / splits;
      const int t = c & 127, warp_in = t >> 5, row0 = (wg - 1) * 128;
      const uint32_t part_s = smem_u32(smem);
      for (int i0 = rank * per; i0 < (int)(rank + 1) * per; i0 += 8) {
        uint32_t sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        const uint32_t local = part_s + 4 * (i0 * CONSUMER_THREADS + c);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < splits) {
            uint32_t remote;
            asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
                : "=r"(remote) : "r"(local), "r"(q));
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              uint32_t v;
              asm("ld.shared::cluster.u32 %0, [%1];\n"
                  : "=r"(v) : "r"(remote + 4 * e * CONSUMER_THREADS));
              sum[e] += v;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          // accumulator i: m64 tile i / 64, register i % 64 of it
          const int i = i0 + e, r = i & (ACC - 1);
          const int m = m0 + row0 + 64 * (i / ACC) + 16 * warp_in +
                        (lane >> 2) + 8 * ((r >> 1) & 1);
          const int n = n0 + 8 * (r >> 2) + 2 * (lane & 3);
          if (m < M && n < N)
            store_pair<KIND>(out, a_scale, w_scale, N, m, n, (int)sum[e],
                             (int)sum[e + 1]);
        }
      }
    }
    cluster_sync();   // no block leaves while its partial may be read
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D uint8 tensor map of a (rows, cols) row-major matrix, boxes of
// (box_rows, box_cols); bytes outside the matrix read as 0.
bool make_map(CUtensorMap* map, const void* p, int rows, int cols,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaLaunchConfig_t launch_config(int depth, int M, int N, int splits,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(depth);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KIND, int DEPTH>
int launch(const void* a, const void* w, const void* a_scale,
           const void* w_scale, void* out, int M, int K, int N, int splits,
           cudaStream_t stream) {
  auto kernel = dcim_mac_tma_kernel<KIND, DEPTH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(DEPTH));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap a_map, w_map;
  if (!make_map(&a_map, a, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&w_map, w, K, N, BK, BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(DEPTH, M, N, splits, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a_map, w_map,
                           static_cast<const float*>(a_scale),
                           static_cast<const float*>(w_scale), out, M, K, N,
                           splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_depth(const void* a, const void* w, const void* a_scale,
                 const void* w_scale, void* out, int M, int K, int N,
                 int depth, int splits, cudaStream_t stream) {
  switch (depth) {
    case 2: return launch<KIND, 2>(a, w, a_scale, w_scale, out, M, K, N,
                                   splits, stream);
    case 3: return launch<KIND, 3>(a, w, a_scale, w_scale, out, M, K, N,
                                   splits, stream);
    case 4: return launch<KIND, 4>(a, w, a_scale, w_scale, out, M, K, N,
                                   splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tma

// ---------------------------------------------------------------------------
// The mma.sync kernel (route `grid`)
// ---------------------------------------------------------------------------

namespace grid {


constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 128;          // K depth of one shared-memory stage
constexpr int THREADS = 128;     // 4 warps, 2 x 2 over the output tile
constexpr int WORDS = BK / 4;    // 32-bit words per shared row

// Word `word` of shared row `row`: 16-byte chunks XOR-swizzled by row & 7.
__device__ __forceinline__ int swz(int row, int word) {
  return row * WORDS + (word ^ ((row & 7) << 2));
}

// 16 bytes of row `r` from column `c` of a (rows, cols) row-major int8
// matrix; bytes outside the matrix read as 0.
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ p, int rows,
                                        int cols, int r, int c, bool vec) {
  if (r >= rows || c >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* q = p + (size_t)r * cols + c;
  if (vec && c + 16 <= cols) return *reinterpret_cast<const uint4*>(q);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (c + b < cols) w[b >> 2] |= (uint32_t)(uint8_t)q[b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Stage {
  uint4 a[4];   // A chunks tid + 128 i: row idx / 8, 16-byte chunk idx % 8
  uint4 w[4];   // W rows 4 lane + i, columns 16 warp .. + 15
};

__device__ __forceinline__ void load_stage(Stage& s, const int8_t* a,
                                           const int8_t* w, int M, int K,
                                           int N, int m0, int n0, int k0,
                                           bool a_vec, bool w_vec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + THREADS * i;
    s.a[i] = load16(a, M, K, m0 + (idx >> 3), k0 + 16 * (idx & 7), a_vec);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s.w[i] = load16(w, K, N, k0 + 4 * lane + i, n0 + 16 * warp, w_vec);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store_stage(const Stage& s, uint32_t* As,
                                            uint32_t* Ws) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + THREADS * i;
    const int r = idx >> 3, c = idx & 7;
    *reinterpret_cast<uint4*>(&As[r * WORDS + ((c ^ (r & 7)) << 2)]) = s.a[i];
  }
  // Four rows k = 4 lane + i of 16 columns: transpose each 4 x 4 byte
  // block so that word j holds column n = 16 warp + 4 q + j at k = 4 lane
  // .. 4 lane + 3 (lowest k in the lowest byte).
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t r0 = word_of(s.w[0], q), r1 = word_of(s.w[1], q);
    const uint32_t r2 = word_of(s.w[2], q), r3 = word_of(s.w[3], q);
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    const int n = 16 * warp + 4 * q;
    Ws[swz(n + 0, lane)] = __byte_perm(t0, t1, 0x5410);
    Ws[swz(n + 1, lane)] = __byte_perm(t0, t1, 0x7632);
    Ws[swz(n + 2, lane)] = __byte_perm(t2, t3, 0x5410);
    Ws[swz(n + 3, lane)] = __byte_perm(t2, t3, 0x7632);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
dcim_mac_grid_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                const float* __restrict__ a_scale,
                const float* __restrict__ w_scale, void* __restrict__ out,
                int M, int K, int N, bool a_vec, bool w_vec) {
  __shared__ __align__(16) uint32_t As[2][BM * WORDS];
  __shared__ __align__(16) uint32_t Ws[2][BN * WORDS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;     // mma fragment coordinates
  const int wm = 32 * (warp >> 1), wn = 32 * (warp & 1);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int stages = (K + BK - 1) / BK;
  Stage s;
  load_stage(s, a, w, M, K, N, m0, n0, 0, a_vec, w_vec);
  store_stage(s, As[0], Ws[0]);
  __syncthreads();

  for (int t = 0; t < stages; ++t) {
    const bool more = t + 1 < stages;
    if (more) load_stage(s, a, w, M, K, N, m0, n0, (t + 1) * BK, a_vec, w_vec);

    const uint32_t* as = As[t & 1];
    const uint32_t* ws = Ws[t & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int k0 = 8 * ks + tig, k1 = k0 + 4;   // words of k 0-15, 16-31
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + gid;
        af[i][0] = as[swz(r, k0)];
        af[i][1] = as[swz(r + 8, k0)];
        af[i][2] = as[swz(r, k1)];
        af[i][3] = as[swz(r + 8, k1)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + gid;
        bf[j][0] = ws[swz(n, k0)];
        bf[j][1] = ws[swz(n, k1)];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }

    if (more) store_stage(s, As[(t + 1) & 1], Ws[(t + 1) & 1]);
    __syncthreads();
  }

  // Accumulator fragment: element v of tile (i, j) is row gid (+8 for v >= 2),
  // column 2 tig (+1 for odd v).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int gm = m0 + wm + 16 * i + gid + 8 * (v >> 1);
        const int gn = n0 + wn + 8 * j + 2 * tig + (v & 1);
        if (gm >= M || gn >= N) continue;
        const size_t o = (size_t)gm * N + gn;
        if constexpr (KIND == OUT_I32) {
          static_cast<int32_t*>(out)[o] = acc[i][j][v];
        } else {
          const float scale = a_scale[gm] * w_scale[gn];
          const float f = (float)acc[i][j][v] * scale;
          if constexpr (KIND == OUT_F32) {
            static_cast<float*>(out)[o] = f;
          } else {
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(f);
          }
        }
      }
    }
  }
}

template <int KIND>
int launch(const void* a, const void* w, const void* a_scale,
           const void* w_scale, void* out, int M, int K, int N,
           cudaStream_t stream) {
  // 16-byte loads need 16-byte aligned rows.
  const bool a_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dcim_mac_grid_kernel<KIND><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      out, M, K, N, a_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grid

}  // namespace

extern "C" {

// (M,K) int8 @ (K,N) int8 on `stream` by the TMA / wgmma kernel (route
// `pipelined`): `kind` 0 stores int32, 1 float32 and 2 bfloat16 through
// the dequant epilogue (a_scale M floats, w_scale N floats; unused for
// kind 0); `depth` 2..4 stages in the ring; K split over a cluster of
// `splits` blocks (1, 2, 4 or 8, at most ceil(K / 128)).  The caller
// guarantees what TMA needs: a and w 16-byte aligned, K and N multiples
// of 16.  Returns the CUDA error code of the launch (0 on success).
int dcim_mac_tma(const void* a, const void* w, const void* a_scale,
                 const void* w_scale, void* out, int M, int K, int N,
                 int kind, int depth, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return tma::launch_depth<OUT_I32>(a, w, a_scale, w_scale, out, M,
                                              K, N, depth, splits, s);
    case 1: return tma::launch_depth<OUT_F32>(a, w, a_scale, w_scale, out, M,
                                              K, N, depth, splits, s);
    case 2: return tma::launch_depth<OUT_BF16>(a, w, a_scale, w_scale, out, M,
                                               K, N, depth, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same product by the mma.sync kernel (route `grid`), for any shape
// and alignment.
int dcim_mac_grid(const void* a, const void* w, const void* a_scale,
                  const void* w_scale, void* out, int M, int K, int N,
                  int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return grid::launch<OUT_I32>(a, w, a_scale, w_scale, out, M, K,
                                         N, s);
    case 1: return grid::launch<OUT_F32>(a, w, a_scale, w_scale, out, M, K,
                                         N, s);
    case 2: return grid::launch<OUT_BF16>(a, w, a_scale, w_scale, out, M, K,
                                          N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one block of the TMA kernel takes at `depth`.
int dcim_mac_tma_smem_bytes(int depth) { return tma::smem_bytes(depth); }

// How many clusters of `splits` TMA blocks (int32 kind) at `depth` the
// card can hold at once, into *count.  Returns the CUDA error code.
int dcim_mac_tma_max_clusters(int depth, int splits, int* count) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      tma::launch_config(depth, tma::BM, tma::BN * 132, splits, nullptr,
                         &attr);
  cudaError_t err = cudaErrorInvalidValue;
  switch (depth) {
#define DCIM_MAC_CLUSTERS(D)                                                 \
  case D: {                                                                  \
    auto kernel = tma::dcim_mac_tma_kernel<OUT_I32, D>;                      \
    err = cudaFuncSetAttribute(kernel,                                       \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               tma::smem_bytes(D));                          \
    if (err == cudaSuccess)                                                  \
      err = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);             \
    break;                                                                   \
  }
    DCIM_MAC_CLUSTERS(2)
    DCIM_MAC_CLUSTERS(3)
    DCIM_MAC_CLUSTERS(4)
#undef DCIM_MAC_CLUSTERS
  }
  return static_cast<int>(err);
}

const char* dcim_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
