// dcim_mac: the DCIM macro's int8 MAC array (paper Fig. 1) on Hopper.
//
// Replaces the Pallas TPU kernels of repro/kernels/dcim_mac/kernel.py:
//   dcim_matmul_int_pallas            (_int_kernel)           -> dcim_mac_int
//   dcim_matmul_int_pipelined_pallas  (_int_pipelined_kernel) -> dcim_mac_int
//   dcim_matmul_pallas                (_mac_kernel)           -> dcim_mac
//   dcim_matmul_pipelined_pallas      (_mac_pipelined_kernel) -> dcim_mac
// The grid and pipelined TPU variants compute the same bits; on the card
// one kernel serves both.
//
// What it computes: C[m][n] = sum_k A[m][k] * W[k][n] with A (M,K) int8 and
// W (K,N) int8, both row-major, accumulated exactly in int32 (wrapping, as
// the TPU kernel's int32 accumulator does).  dcim_mac_int stores C as int32.
// dcim_mac applies the dequant epilogue
//   out[m][n] = (float)C[m][n] * (a_scale[m] * w_scale[n])
// (the scale product first, as the TPU kernel does) and stores float32, or
// bfloat16 rounded to nearest even.  No add follows a multiply, so there is
// nothing for FMA contraction to change.
//
// Design.  One block of 4 warps computes a 64 x 64 output tile; each warp a
// 32 x 32 quarter as 2 x 4 tensor-core products mma.sync m16n8k32
// s8.s8.s32.  The block walks K itself in 128-deep stages, which replaces
// the TPU's sequential K grid axis.  A stage of A (64 x 128) and of W
// (128 x 64) is staged in shared memory, both k-contiguous as the 8-bit
// mma wants them: A as it lies in memory, W transposed on the way in (each
// thread loads four 16-byte rows of W and transposes 4 x 4 byte blocks in
// registers with __byte_perm).  Shared rows are 128 bytes with the 16-byte
// chunks XOR-swizzled by row, so the staging stores and the fragment loads
// hit 32 distinct banks.  Two shared buffers and a register prefetch of the
// next stage let the global loads of stage t+1 overlap the products of
// stage t, with one barrier per stage.  Loads past the ragged edges of M,
// K and N read as 0 (16-byte vector loads where the row allows, bytes
// otherwise), and stores past M and N are masked, instead of padding.
//
// Bound on the H100 SXM (NVIDIA data sheet, dense): int8 work is 2 M K N
// operations at 1,979 TOPS against M K + K N + 4 M N bytes at 3.35 TB/s.
// At the qwen3-4b GEMMs (M = 256 tokens) the bytes bound: for example
// mlp_up (256 x 2560 x 19456) needs 12.9 us of tensor-core work but 21 us
// of memory traffic.
//
// What this simple design leaves on the table: mma.sync reaches only part
// of the tensor cores' rate (wgmma is the full-rate path); the register
// prefetch keeps one stage in flight, not a deep TMA/mbarrier ring, so the
// narrow GEMMs (M = 256, N = 1024: 64 blocks on 132 SMs) stay bound by load
// latency; W is transposed on every call although a weight could be stored
// k-contiguous once.  The TPU `depth` knob has no meaning here yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 128;          // K depth of one shared-memory stage
constexpr int THREADS = 128;     // 4 warps, 2 x 2 over the output tile
constexpr int WORDS = BK / 4;    // 32-bit words per shared row

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

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
dcim_mac_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
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
           void* stream) {
  // 16-byte loads need 16-byte aligned rows.
  const bool a_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dcim_mac_kernel<KIND><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      out, M, K, N, a_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (M,K) int8 @ (K,N) int8 -> (M,N) int32 on `stream`.  Returns the CUDA
// error code of the launch (0 on success).
int dcim_mac_int(const void* a, const void* w, void* out, int M, int K, int N,
                 void* stream) {
  return launch<OUT_I32>(a, w, nullptr, nullptr, out, M, K, N, stream);
}

// The same product with the dequant epilogue; out is float32, or bfloat16
// when out_bf16 is nonzero.  a_scale has M floats, w_scale N floats.
int dcim_mac(const void* a, const void* w, const void* a_scale,
             const void* w_scale, void* out, int M, int K, int N, int out_bf16,
             void* stream) {
  if (out_bf16)
    return launch<OUT_BF16>(a, w, a_scale, w_scale, out, M, K, N, stream);
  return launch<OUT_F32>(a, w, a_scale, w_scale, out, M, K, N, stream);
}

const char* dcim_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
