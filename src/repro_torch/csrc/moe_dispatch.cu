// moe_dispatch: the MoE layer's Switch/GShard slot assignment (capacity
// dispatch) in one launch on Hopper.
//
// Replaces no TPU kernel.  The JAX package writes the assignment as plain
// jnp ops (repro/models/moe.py: _top_k_dispatch) and leaves them to XLA's
// fusion; the port ran them as ~24 eager aten passes for each of the k
// choices (models/moe.py: _slots_ref, its plain version, which CPU tensors
// still run).  Every MoE layer of a forward pass on the card calls it once,
// in serving and in training (models/moe.py: _CardSlots, its gradient).
//
// What it computes, for each group g of S tokens whose k choices are
// (topv, topi) (G, S, k), largest first: the choices are taken slot by
// slot, j = 0..k-1, and within a slot token by token.  The j-th choice of
// token s, expert e = topi[g, s, j], gets position
//   pos = (choices of e in slots before j, over the whole group)
//       + (tokens t < s whose j-th choice is e)
// and holds slot `pos` of e when pos < C (else it drops).  Out:
//   dispatch[g, s, e, c] = 1 where that choice holds slot c, else 0 (bool)
//   combine[g, s, e, c]  = topv[g, s, j] there, else +0.0 (float32)
//   held[g, s, e]        = 1.0 where token s holds any slot of e, else 0.0
// A token's k experts are distinct, so each (g, s, e) gets at most one
// choice: the plain version's sum over the slots, 0 + 1.0 * v, is v bit
// for bit, and held is its dispatch.any(-1) as float32.
//
// Design.  The counting is ~S * k integers a group; the outputs are S * E
// * C elements a group (2.6 M at granite's decode: 4 groups of 256 tokens,
// 40 experts, 64 slots), so the writes bound the launch, and they are
// spread over the card: a block takes a tile of `tile` tokens of one
// group (grid (G, ceil(S / tile))) and writes every element of its
// tokens' rows, zeros included, so no fill runs before it.  Each block
// counts its group's choices again (S * k shared-memory atomics on k x E
// counters), which costs less than a second launch and a scratch array:
//   1. counts by (slot, expert) over the group and over the tokens before
//      the tile; the tile's own choices kept in shared memory;
//   2. per expert, the exclusive sum over the slots (the plain version's
//      prio_used) plus the count before the tile;
//   3. each of the tile's (token, slot) adds the tile's earlier tokens of
//      the same slot and expert, and notes (slot, topv) under (token,
//      expert) where it holds one;
//   4. the tile's rows written densely: 16-byte stores of combine and
//      4-byte stores of dispatch where C is a multiple of 4, else scalar.
// The host picks the tile (kernels/moe_dispatch/kernel.py:tile_tokens):
// 32 tokens, halved down to 4 while the grid has fewer than two blocks an
// SM, and halved further while the shared memory exceeds 48 KB.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 48 * 1024;

template <int VEC>
__global__ void __launch_bounds__(THREADS) moe_dispatch_kernel(
    const float* __restrict__ topv, const long long* __restrict__ topi,
    long long v_g, long long v_s, long long i_g, long long i_s, int S, int E,
    int k, int C, int tile, unsigned char* __restrict__ dispatch,
    float* __restrict__ combine, float* __restrict__ held) {
  extern __shared__ int sm[];
  int* const first = sm;                  // [k][E] the group's counts
  int* const before = first + k * E;      // [k][E] those before the tile
  int* const choice = before + k * E;     // [tile][k] the tile's experts
  int* const slot = choice + tile * k;    // [tile][E] slot held, or -1
  float* const val = reinterpret_cast<float*>(slot + tile * E);  // [tile][E]

  const int g = blockIdx.x;
  const int s0 = blockIdx.y * tile;
  const int n = min(tile, S - s0);
  const long long* const ti = topi + g * i_g;
  const float* const tv = topv + g * v_g;

  for (int i = threadIdx.x; i < 2 * k * E; i += THREADS) sm[i] = 0;
  for (int i = threadIdx.x; i < tile * E; i += THREADS) slot[i] = -1;
  __syncthreads();
  // 1. the group's choices counted by (slot, expert)
  for (int i = threadIdx.x; i < S * k; i += THREADS) {
    const int t = i / k, j = i - t * k;
    const int e = static_cast<int>(ti[t * i_s + j]);
    atomicAdd(&first[j * E + e], 1);
    if (t < s0)
      atomicAdd(&before[j * E + e], 1);
    else if (t < s0 + n)
      choice[(t - s0) * k + j] = e;
  }
  __syncthreads();
  // 2. slot j's first position of expert e for the tile's first token
  for (int e = threadIdx.x; e < E; e += THREADS) {
    int run = 0;
    for (int j = 0; j < k; ++j) {
      const int c = first[j * E + e];
      first[j * E + e] = run + before[j * E + e];
      run += c;
    }
  }
  __syncthreads();
  // 3. the tile's positions; a token's experts are distinct, so each
  //    (token, expert) is written at most once
  for (int i = threadIdx.x; i < n * k; i += THREADS) {
    const int r = i / k, j = i - r * k;
    const int e = choice[i];
    int pos = first[j * E + e];
    for (int q = 0; q < r; ++q) pos += choice[q * k + j] == e;
    if (pos < C) {
      slot[r * E + e] = pos;
      val[r * E + e] = tv[(s0 + r) * v_s + j];
    }
  }
  __syncthreads();
  // 4. the tile's rows (token, expert), every element
  const long long row0 = (static_cast<long long>(g) * S + s0) * E;
  const int rows = n * E;
  for (int r = threadIdx.x; r < rows; r += THREADS)
    held[row0 + r] = slot[r] >= 0 ? 1.0f : 0.0f;
  const int per_row = C / VEC;
  float* const cb = combine + row0 * C;
  unsigned char* const db = dispatch + row0 * C;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row;
    const int c0 = (i - r * per_row) * VEC;
    const int sl = slot[r];
    const float v = sl >= 0 ? val[r] : 0.0f;
    if constexpr (VEC == 4) {
      float4 f;
      f.x = sl == c0 ? v : 0.0f;
      f.y = sl == c0 + 1 ? v : 0.0f;
      f.z = sl == c0 + 2 ? v : 0.0f;
      f.w = sl == c0 + 3 ? v : 0.0f;
      uchar4 d = make_uchar4(sl == c0, sl == c0 + 1, sl == c0 + 2,
                             sl == c0 + 3);
      reinterpret_cast<float4*>(cb)[i] = f;
      reinterpret_cast<uchar4*>(db)[i] = d;
    } else {
      cb[i] = sl == c0 ? v : 0.0f;
      db[i] = sl == c0;
    }
  }
}

// Shared memory a block takes (bytes).
int smem_bytes(int E, int k, int tile) {
  return static_cast<int>(sizeof(int)) * (2 * k * E + tile * k + 2 * tile * E);
}

}  // namespace

extern "C" {

// One launch on `stream`.  topv float32 and topi int64 (G, S, k), element
// (g, s, j) at g * v_g + s * v_s + j (topv) and g * i_g + s * i_s + j
// (topi); dispatch (bool as bytes), combine and held contiguous (G, S, E,
// C) and (G, S, E).  Every expert id must lie in [0, E) and a token's k
// ids must be distinct.  `tile` tokens a block, 1..32.
int moe_dispatch(const float* topv, const long long* topi, long long v_g,
                 long long v_s, long long i_g, long long i_s, int G, int S,
                 int E, int k, int C, int tile, void* dispatch,
                 float* combine, float* held, cudaStream_t stream) {
  const int tiles = (S + tile - 1) / tile;
  const int smem = smem_bytes(E, k, tile);
  if (G < 1 || S < 1 || E < 1 || k < 1 || k > E || C < 1 || tile < 1 ||
      tile > 32 || tiles > 65535 || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(G), static_cast<unsigned>(tiles));
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(combine) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(dispatch) % 4 == 0;
  auto* d = static_cast<unsigned char*>(dispatch);
  if (vec)
    moe_dispatch_kernel<4><<<grid, THREADS, smem, stream>>>(
        topv, topi, v_g, v_s, i_g, i_s, S, E, k, C, tile, d, combine, held);
  else
    moe_dispatch_kernel<1><<<grid, THREADS, smem, stream>>>(
        topv, topi, v_g, v_s, i_g, i_s, S, E, k, C, tile, d, combine, held);
  return static_cast<int>(cudaGetLastError());
}

const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
