// fake_quant: the DCIM linear layers' symmetric per-slice fake-quant
// (quantise to signed `bits` integers and back) in one launch on Hopper.
//
// Replaces no TPU kernel.  The JAX package writes the fake-quant as plain
// jnp ops (repro/quant/quantizers.py: quantize_int, fake_quant) and leaves
// them to XLA's fusion; the port ran them as twelve eager aten passes and
// two host-made scalar tensors per call (quant/quantizers.py:quantize_int,
// its plain version, which CPU tensors still take).  The models call it on
// every DCIM weight and activation of every forward pass.
//
// What it computes, for a contiguous (outer, R, inner) view reduced over R
// (a slice is the R elements of one (outer, inner) pair), in the input's
// dtype T (bf16, f16 or f32), with rnd() rounding a float to T:
//   amax  = max |x| over the slice (a NaN anywhere makes it NaN)
//   scale = rnd(max(amax, floor) / qmax)           max propagates NaN
//   q     = clamp(rint(rnd(x / scale)), -qmax - 1, qmax), then to int8
//   out   = rnd(q * scale)
// floor and qmax are the very values the plain version's tensors hold
// (1e-8 and 2^(bits-1) - 1 as T: f16 rounds 1e-8 to 0), given by the host.
//
// Exactness.  Every output carries the plain version's bits on the card.
// aten computes each bf16/f16 op in float and rounds the result to T, so
// the kernel does too, at the same places: the quotient x / scale is
// rounded to T before rint (a double rounding: a quotient may land on
// x.5 only after it), and rint is half to even.  Divisions are __fdiv_rn
// (never a reciprocal multiply) and products __fmul_rn; the build has no
// fast-math.  |x| is compared as the bits of a non-negative float, where
// every NaN lies above +inf, so the max propagates NaN as amax does (fmaxf
// would drop it).  A NaN q goes to int8 by the same cast aten's .to(int8)
// makes; the sign of a zero is lost there in both.
//
// Design.  Bytes bound it: the operand is read once and the result
// written once (2 x 2 bytes an element in bf16), against ~30 bytes an
// element moved by the twelve passes.  Two routes, by layout:
//  * rows (inner == 1, the activations' per-token slices): one block per
//    row, 16-byte loads, each thread keeping up to KEEP_ROWS vectors in
//    registers, so a row of up to 512 x 8 vectors is read once (a longer
//    one re-reads its tail).  A row may be strided (ld) if its elements
//    are contiguous.
//  * cols (inner > 1, the weights' per-column slices): a block takes a
//    tile of CW columns (128 bytes a row with 16-byte loads) and a part of
//    the R rows, each thread keeping up to KEEP_COLS vectors in registers.
//    Where R is long, or one block per tile would not fill the card, a
//    cluster of P blocks (P <= 8) splits the rows, and the column maxima
//    meet in distributed shared memory, so every element is still read
//    once (a part longer than KEEP_COLS x TY rows re-reads its tail from
//    L2).  Blocks of 256 threads at most 128 registers, so that two share
//    an SM: one block's loads overlap the other's reduction and stores
//    (occupancy moved the time more than re-reads did: KEEP_COLS 16 at one
//    block an SM took 1.5x as long).
// A misaligned operand or a width not a multiple of the vector takes the
// same code with one element a load.  `codes`, where not null, receives q
// (int8, the result's layout), for recorders that compare codes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KEEP_ROWS = 8;     // vectors a thread keeps, rows route
constexpr int KEEP_COLS = 8;     // vectors a thread keeps, cols route
constexpr int COL_THREADS = 256;
constexpr int MAX_CLUSTER = 8;

// T <-> float, and rnd(): round a float to T and read it back
template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Num<__half> {
  static __device__ __forceinline__ float to_f(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from_f(float v) {
    return __float2half_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Num<T>::to_f(Num<T>::from_f(v));
}

// VEC elements of T loaded or stored as one access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ unsigned umax(unsigned a, unsigned b) {
  return a > b ? a : b;
}

// |v| as the bits of a non-negative float: NaN > +inf > every finite
template <typename T>
__device__ __forceinline__ unsigned abs_bits(T v) {
  return __float_as_uint(fabsf(Num<T>::to_f(v)));
}

// scale = rnd(max(amax, floor) / qmax), torch.maximum's NaN included
template <typename T>
__device__ __forceinline__ float scale_of(unsigned amax_bits, float floor,
                                          float qmax) {
  const float a = __uint_as_float(amax_bits);
  const float m = (isnan(a) || a > floor) ? a : floor;
  return rnd<T>(__fdiv_rn(m, qmax));
}

// one element: the code q and the dequantised value
template <typename T>
__device__ __forceinline__ T quant(T x, float scale, float qmax,
                                   int8_t* code) {
  float q = rintf(rnd<T>(__fdiv_rn(Num<T>::to_f(x), scale)));
  if (!isnan(q)) q = fminf(fmaxf(q, -qmax - 1.0f), qmax);
  const int8_t c = static_cast<int8_t>(q);
  *code = c;
  return Num<T>::from_f(__fmul_rn(static_cast<float>(c), scale));
}

template <typename T, int VEC>
__device__ __forceinline__ unsigned pack_max(const Pack<T, VEC>& p,
                                             unsigned m) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) m = umax(m, abs_bits(p.v[j]));
  return m;
}

// store one pack's result (and its codes, where wanted) at element `at`
template <typename T, int VEC>
__device__ __forceinline__ void put_row(const Pack<T, VEC>& p, float scale,
                                        float qmax, Pack<T, VEC>* out,
                                        int8_t* codes, long long at) {
  Pack<T, VEC> r;
  int8_t c[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = quant(p.v[j], scale, qmax, &c[j]);
  out[at / VEC] = r;
  if (codes != nullptr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) codes[at + j] = c[j];
  }
}

// the block's max of every thread's m (blockDim.x a multiple of 32)
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned part[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    unsigned v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

// Rows route: block b takes row b of a (rows, R) operand with row stride
// `ld` (elements); the result is written contiguous (rows, R).
template <typename T, int VEC>
__global__ void __launch_bounds__(512)
    fake_quant_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int8_t* __restrict__ codes, long long R,
                           long long ld, float floor, float qmax) {
  using P = Pack<T, VEC>;
  const long long row = blockIdx.x;
  const P* src = reinterpret_cast<const P*>(x + row * ld);
  P* dst = reinterpret_cast<P*>(out + row * R);
  int8_t* cdst = codes == nullptr ? nullptr : codes + row * R;
  const long long nvec = R / VEC;
  const int tid = threadIdx.x, nt = blockDim.x;
  P keep[KEEP_ROWS];
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < KEEP_ROWS; ++k) {
    const long long i = tid + (long long)k * nt;
    if (i < nvec) {
      keep[k] = src[i];
      m = pack_max(keep[k], m);
    }
  }
  for (long long i = tid + (long long)KEEP_ROWS * nt; i < nvec; i += nt)
    m = pack_max(src[i], m);
  const float scale = scale_of<T>(block_max(m), floor, qmax);
#pragma unroll
  for (int k = 0; k < KEEP_ROWS; ++k) {
    const long long i = tid + (long long)k * nt;
    if (i < nvec) put_row(keep[k], scale, qmax, dst, cdst, i * VEC);
  }
  for (long long i = tid + (long long)KEEP_ROWS * nt; i < nvec; i += nt)
    put_row(src[i], scale, qmax, dst, cdst, i * VEC);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// `local` (a shared-memory word of this block) in block `rank` of the
// cluster
__device__ __forceinline__ unsigned cluster_load(const unsigned* local,
                                                 unsigned rank) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// Cols route on a contiguous (outer, R, inner) operand.  A block is
// (column tile, part p of `parts`) x outer index: grid.x is tile * parts
// + p (a cluster of `parts` blocks along x), grid.y walks the outer
// index.  Its threads are TX columns (VEC elements each) x TY rows; the
// block's rows are [p * rows_per, (p + 1) * rows_per) of R.
template <typename T, int VEC>
__global__ void __launch_bounds__(COL_THREADS, 2)
    fake_quant_cols_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int8_t* __restrict__ codes, long long outer,
                           long long R, long long inner, long long rows_per,
                           int parts, float floor, float qmax) {
  constexpr int TX = VEC > 1 ? 8 : 32;   // threads along the columns
  constexpr int TY = COL_THREADS / TX;   // threads along the rows
  constexpr int CW = TX * VEC;           // columns a block takes
  using P = Pack<T, VEC>;
  __shared__ unsigned red[TY][CW];
  __shared__ unsigned colmax[CW];        // this block's, read by the cluster
  __shared__ unsigned fin[CW];           // the cluster's
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int part = blockIdx.x % parts;
  const long long col = (long long)(blockIdx.x / parts) * CW + tx * VEC;
  const bool live = col < inner;         // inner % VEC == 0 where VEC > 1
  const long long r0 = part * rows_per;
  const long long r1 = r0 + rows_per < R ? r0 + rows_per : R;
  for (long long o = blockIdx.y; o < outer; o += gridDim.y) {
    const long long base = o * R * inner + col;
    unsigned m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = 0;
    P keep[KEEP_COLS];
#pragma unroll
    for (int k = 0; k < KEEP_COLS; ++k) {
      const long long r = r0 + ty + (long long)k * TY;
      if (live && r < r1) {
        keep[k] = *reinterpret_cast<const P*>(x + base + r * inner);
#pragma unroll
        for (int j = 0; j < VEC; ++j) m[j] = umax(m[j], abs_bits(keep[k].v[j]));
      }
    }
    for (long long r = r0 + ty + (long long)KEEP_COLS * TY; live && r < r1;
         r += TY) {
      const P p = *reinterpret_cast<const P*>(x + base + r * inner);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m[j] = umax(m[j], abs_bits(p.v[j]));
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[ty][tx * VEC + j] = m[j];
    __syncthreads();
    for (int c = threadIdx.x; c < CW; c += COL_THREADS) {
      unsigned v = 0;
      for (int t = 0; t < TY; ++t) v = umax(v, red[t][c]);
      colmax[c] = v;
    }
    if (parts > 1) {
      cluster_sync();                    // every part's maxima are written
      for (int c = threadIdx.x; c < CW; c += COL_THREADS) {
        unsigned v = 0;
        for (int q = 0; q < parts; ++q)
          v = umax(v, cluster_load(&colmax[c], q));
        fin[c] = v;
      }
      cluster_sync();                    // no block moves on while read
    } else {
      __syncthreads();
      for (int c = threadIdx.x; c < CW; c += COL_THREADS) fin[c] = colmax[c];
      __syncthreads();
    }
    float scale[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      scale[j] = scale_of<T>(fin[tx * VEC + j], floor, qmax);
    // one row's pack of VEC columns: its result and codes
    auto put = [&](const P& p, long long r) {
      P res;
      int8_t c[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        res.v[j] = quant(p.v[j], scale[j], qmax, &c[j]);
      *reinterpret_cast<P*>(out + base + r * inner) = res;
      if (codes != nullptr) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) codes[base + r * inner + j] = c[j];
      }
    };
#pragma unroll
    for (int k = 0; k < KEEP_COLS; ++k) {
      const long long r = r0 + ty + (long long)k * TY;
      if (live && r < r1) put(keep[k], r);
    }
    for (long long r = r0 + ty + (long long)KEEP_COLS * TY; live && r < r1;
         r += TY)
      put(*reinterpret_cast<const P*>(x + base + r * inner), r);
  }
}

template <typename T, int VEC>
int launch_rows(const void* x, void* out, void* codes, long long rows,
                long long R, long long ld, float floor, float qmax,
                int threads, cudaStream_t stream) {
  fake_quant_rows_kernel<T, VEC><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<int8_t*>(codes), R, ld, floor, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_cols(const void* x, void* out, void* codes, long long outer,
                long long R, long long inner, long long rows_per, int parts,
                int tiles, int grid_y, float floor, float qmax,
                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * parts), (unsigned)grid_y, 1);
  cfg.blockDim = dim3(COL_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = parts;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fake_quant_cols_kernel<T, VEC>, static_cast<const T*>(x),
      static_cast<T*>(out), static_cast<int8_t*>(codes), outer, R, inner,
      rows_per, parts, floor, qmax);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes of the C interface
enum { F32 = 0, BF16 = 1, F16 = 2 };

}  // namespace

extern "C" {

// The rows route: `rows` rows of R elements, row stride `ld` (elements);
// `vec` 1 or 16 / sizeof(T) (R, ld and x 16-byte aligned then); `threads`
// a multiple of 32, at most 512.  `codes` may be null.
int fake_quant_rows(int dtype, const void* x, void* out, void* codes,
                    long long rows, long long R, long long ld, int vec,
                    float floor, float qmax, int threads,
                    cudaStream_t stream) {
  if (threads < 32 || threads > 512 || threads % 32 != 0 || rows < 1 ||
      rows >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec > 1;
  switch (dtype) {
    case F32:
      return v ? launch_rows<float, 4>(x, out, codes, rows, R, ld, floor,
                                       qmax, threads, stream)
               : launch_rows<float, 1>(x, out, codes, rows, R, ld, floor,
                                       qmax, threads, stream);
    case BF16:
      return v ? launch_rows<__nv_bfloat16, 8>(x, out, codes, rows, R, ld,
                                               floor, qmax, threads, stream)
               : launch_rows<__nv_bfloat16, 1>(x, out, codes, rows, R, ld,
                                               floor, qmax, threads, stream);
    case F16:
      return v ? launch_rows<__half, 8>(x, out, codes, rows, R, ld, floor,
                                        qmax, threads, stream)
               : launch_rows<__half, 1>(x, out, codes, rows, R, ld, floor,
                                        qmax, threads, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cols route on a contiguous (outer, R, inner) operand: `tiles` column
// tiles of the vector's width, each split over a cluster of `parts` blocks
// (1..8) taking `rows_per` rows; grid.y `grid_y` (<= 65535) walks outer.
// `vec` 1 or 16 / sizeof(T) (inner and x 16-byte aligned then).
int fake_quant_cols(int dtype, const void* x, void* out, void* codes,
                    long long outer, long long R, long long inner, int vec,
                    float floor, float qmax, int tiles, int parts,
                    long long rows_per, int grid_y, cudaStream_t stream) {
  if (parts < 1 || parts > MAX_CLUSTER || tiles < 1 || grid_y < 1 ||
      grid_y > 65535 || (long long)tiles * parts >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec > 1;
  switch (dtype) {
    case F32:
      return v ? launch_cols<float, 4>(x, out, codes, outer, R, inner,
                                       rows_per, parts, tiles, grid_y, floor,
                                       qmax, stream)
               : launch_cols<float, 1>(x, out, codes, outer, R, inner,
                                       rows_per, parts, tiles, grid_y, floor,
                                       qmax, stream);
    case BF16:
      return v ? launch_cols<__nv_bfloat16, 8>(x, out, codes, outer, R,
                                               inner, rows_per, parts, tiles,
                                               grid_y, floor, qmax, stream)
               : launch_cols<__nv_bfloat16, 1>(x, out, codes, outer, R,
                                               inner, rows_per, parts, tiles,
                                               grid_y, floor, qmax, stream);
    case F16:
      return v ? launch_cols<__half, 8>(x, out, codes, outer, R, inner,
                                        rows_per, parts, tiles, grid_y,
                                        floor, qmax, stream)
               : launch_cols<__half, 1>(x, out, codes, outer, R, inner,
                                        rows_per, parts, tiles, grid_y,
                                        floor, qmax, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fake_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
