#!/usr/bin/env python3
"""Where the dominance kernel's time goes (rows A2 and A3): the screen and
split passes of each frontier call of the compiler's main path, timed and
counted, and the kernel compared with variants of its own text.

    python3 probes/dominance_split.py [SOURCE ...]

On one CUDA card: ``design_space_sweep_many`` of the four scenario specs at
the full registered lattice, then ``frontier_indices()`` of each sweep with
its dominance calls recorded (``chip_smoke._recorded_dominance``: the A2
calls, one per frontier), then the same for the sharded sweeps on the
card's mesh (A3: per frontier one ``seg`` call, phase 1, and one against
every row, phase 2).  Each call then runs through the binding
(``kernels/pareto_dominated/kernel.py``, its library swapped through
``kernel.bind``) on builds of text variants of the source (VARIANTS):

- ``as_built``: the source as it is;
- ``cp_async``: the split pass's TMA bulk copies turned off (every chunk
  staged by 8-byte ``cp.async``);
- ``one_wave``, ``two_waves``, ``eight_waves``: the split's items for 1, 2
  or 8 waves of the grid instead of 4 (``kWaves``);
- ``full_slabs``: the split's slabs of 256 survivors whatever their count;
- ``solo_tail``: the screen's tail left to each candidate's lane (no
  ``screen_tail``);
- ``all_lanes``: the screen's warps filling all 32 lanes whatever the
  candidate count, on a block per 256 candidates;
- ``cached``: the occupancy query made once per kernel;
- ``noop``: a screen that returns at once, so that its split finds no
  survivor: the floor of the two launches (timed only, TIMING_ONLY);
- and each SOURCE given: a copy of the source with the same C interface
  (say an earlier version's), named by its path.

Each other build runs in turns with the first (as built, other, other, as
built; ``ROUNDS`` rounds), each run timed as ``chip_smoke.py`` times a
kernel (the L2 cache flushed and the device spun first), each pass apart
from the CUDA events the binding records.  Then the call runs once through
a build with counters patched into the split kernel (device atomics; the
counted run is slower and its times are not reported): the work items, the
survivors live at an item's start, the chunks walked, the survivors live
per chunk, the steps the units took (a step: 128 rows of one group) and
those that ran the float64 test.  Prints one JSON line per call (the
medians of each build), one per row and build with the sums over its calls
(per round position: median, least and most), and the card's name.  Exits
non-zero if a verdict differs from the recorded one.

    python3 probes/dominance_split.py --wide

The wide route (more than 8 objectives): the calls of ``chip_smoke.py``'s
wide step, recorded (8,192 near ties at 12 objectives through
``batched.pareto_mask`` and the sharded mask on four entries of card 0:
nine calls; 65,536 near ties at 16 objectives through ``pareto_mask``: one
call), each run through the wide kernels as built and through the first
wide kernel (``OLD_WIDE``, its text carried here: a warp per candidate, one
row a lane a step), in turns (old, new, new, old; ``ROUNDS`` rounds), then
through text variants of the source (``WIDE_VARIANTS``: the launch floor,
no row compared, a float32 compare in place of the float64 `<=`) in turns
with the source as built; the verdicts of every build but the timing-only
ones held against the recorded ones.  Each call also runs once through a
traced build (``WIDE_TRACE``: each block's start and end on the global
timer, counts of groups, chunks and items; its times are not reported).
Then, as the control, the A2 and A3 calls of the compiler's frontiers
(k = 3) through the source as built, by their own kernels (screen, split)
and by the wide ones in turns (narrow, wide, wide, narrow), both held to
the recorded verdicts.  Prints one JSON line per call and one per set and
build with the sums over its calls, and the card's name and power limit.
"""

import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

#: Counters patched into the split kernel: (marker, code after it).
COUNTERS = [
    ("#include <stdint.h>\n",
     "__device__ unsigned long long g_probe[8];\n"),
    ("    const int64_t chunks = (s_hi - s_lo + kChunk - 1) / kChunk;\n",
     "    { const unsigned lv = __ballot_sync(kFull, live);\n"
     "      if (lane == 0) atomicAdd(&g_probe[1], __popc(lv));\n"
     "      if (threadIdx.x == 0) atomicAdd(&g_probe[0], 1ull); }\n"),
    ("      const int groups = (live_count + kGroup - 1) / kGroup;\n",
     "      if (threadIdx.x == 0) { atomicAdd(&g_probe[2], 1ull);\n"
     "        atomicAdd(&g_probe[3], (unsigned long long)live_count); }\n"),
    ("        for (int r0 = u_lo; r0 < u_hi && open; r0 += 32 * kLaneRows) "
     "{\n",
     "          if (lane == 0) atomicAdd(&g_probe[4], 1ull);\n"),
    ("          if (!need) continue;\n",
     "          if (lane == 0) atomicAdd(&g_probe[5], 1ull);\n"),
]
NAMES = ["items", "live_at_item_start", "chunks", "live_per_chunk_sum",
         "steps", "float64_steps"]
PROBE_API = """
extern "C" int probe_read(unsigned long long* h) {
  return cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));
}
extern "C" int probe_zero() {
  static unsigned long long z[8];
  return cudaMemcpyToSymbol(g_probe, z, sizeof(g_probe));
}
"""


def counted_text(text: str) -> str:
    for marker, code in COUNTERS:
        if text.count(marker) != 1:
            raise SystemExit(f"marker not found once: {marker!r}")
        text = text.replace(marker, marker + code)
    return text + PROBE_API


#: The split's items per resident block (``kWaves``), and the patch that
#: sets it to ``w``.
WAVES = "constexpr int kWaves = 4;"


def waves(w: int) -> tuple[str, str]:
    return WAVES, WAVES.replace("4", str(w))


#: The screen's tail handed back to the lanes: each open candidate scanned
#: by its own lane to the end of its rows, as before ``screen_tail``.
SOLO_TAIL = (
    "      if (drained) {\n"
    "        screen_tail<K>(sm.rows, sm.low, len, whole, i, q, upper, lower,"
    " up,\n"
    "                       out, survivors, count);\n"
    "        break;\n"
    "      }\n"
    "      if (__ballot_sync(kFull, i >= 0) == 0) continue;\n",
    "      if (__ballot_sync(kFull, i >= 0) == 0) {\n"
    "        if (drained) break;\n"
    "        continue;\n"
    "      }\n")

#: The occupancy query's result kept per kernel after its first call:
#: (marker, code inserted after it).
CACHED = [
    ("cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks,\n"
     "                            int threads = kThreads) {\n",
     "  static const void* seen[64];\n  static int seen_blocks[64], n_seen;\n"
     "  for (int i = 0; i < n_seen; ++i)\n"
     "    if (seen[i] == reinterpret_cast<const void*>(kernel)) {\n"
     "      *blocks = seen_blocks[i];\n      return cudaSuccess;\n    }\n"),
    ("  *blocks = sms * (per_sm > 0 ? per_sm : 1);\n",
     "  seen[n_seen] = reinterpret_cast<const void*>(kernel);\n"
     "  seen_blocks[n_seen++] = *blocks;\n"),
]

#: Builds compared, each as text patches of the source: (old, new).
VARIANTS = {
    "as_built": [],
    "cp_async": [("  const bool bulk =\n      (reinterpret_cast<uintptr_t>"
                  "(src) & 15) == 0 && (bytes & 15) == 0;\n",
                  "  const bool bulk = false;\n")],
    "one_wave": [waves(1)],
    "two_waves": [waves(2)],
    "eight_waves": [waves(8)],
    "full_slabs": [("max(int64_t{32}, (per + 31) / 32 * 32)",
                    "int64_t{kThreads}")],  # both splits
    "solo_tail": [SOLO_TAIL],
    "all_lanes": [("  const int lanes = seg > 0 ? 32\n",
                   "  const int lanes = true ? 32\n"),
                  ("              : (c + 31) / 32;\n",
                   "              : (c + kThreads - 1) / kThreads;\n")],
    "cached": [(m, m + code) for m, code in CACHED],
    "noop": [("  ScreenSmem<K>& sm = *reinterpret_cast<ScreenSmem<K>*>"
              "(smem_raw);\n",
              "  ScreenSmem<K>& sm = *reinterpret_cast<ScreenSmem<K>*>"
              "(smem_raw);\n  if (n >= 0) return;\n")],
}

#: Variants timed but not held to the verdicts: ``noop``'s screen returns
#: at once (and its split finds no survivor), the floor of the two
#: launches.
TIMING_ONLY = {"noop"}

#: Rounds of (as built, other, other, as built) per call.
ROUNDS = 5


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def run(K, lib, call, flush=None):
    """One call through the binding on ``lib``: (verdicts, stats).  With
    ``flush``, the L2 cache is flushed and the device spun first."""
    import torch

    from repro_torch.kernels.timing import SPIN_CYCLES
    rows, cands, eps, seg = call[:4]
    if flush is not None:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
    saved, K._lib = K._lib, lambda: lib
    try:
        stats = {}
        out = K.pareto_dominated_cuda(rows, cands, eps, seg, stats=stats)
    finally:
        K._lib = saved
    return out, stats


#: The first wide kernel, as it was in ``csrc/pareto_dominated.cu``: a warp
#: per candidate from a device queue, its lanes striding the rows of its
#: test one row a lane a step, ``__any_sync`` after each step.  The baseline
#: of ``--wide``; its C entry point takes the binding's operands and a
#: zeroed 64-bit queue.
OLD_WIDE = r"""
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWideStage = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

__global__ void __launch_bounds__(kThreads)
    wide_kernel(const double* __restrict__ rows, int64_t n,
                const double* __restrict__ cands, int64_t c, int64_t k,
                double eps, int64_t seg, bool* __restrict__ out,
                unsigned long long* __restrict__ queue) {
  __shared__ double staged[kWarps][2][kWideStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in_smem = k <= kWideStage;
  double* upper = staged[warp][0];
  double* lower = staged[warp][1];
  for (;;) {
    unsigned long long got = 0;
    if (lane == 0) got = atomicAdd(queue, 1ull);
    const int64_t i =
        static_cast<int64_t>(__shfl_sync(kFull, got, 0));
    if (i >= c) break;
    const double* cand = cands + i * k;
    if (in_smem) {
      __syncwarp();
      for (int64_t d = lane; d < k; d += 32) {
        upper[d] = __dadd_rn(cand[d], eps);
        lower[d] = __dsub_rn(cand[d], eps);
      }
      __syncwarp();
    }
    int64_t lo = 0, hi = n;
    if (seg > 0) {
      lo = i / seg * seg;
      hi = min(lo + seg, n);
    }
    bool found = false;
    for (int64_t r0 = lo; k > 0 && r0 < hi && !found; r0 += 32) {
      const int64_t r = r0 + lane;
      bool hit = false;
      if (r < hi) {
        const double* x = rows + r * k;
        bool le = true, lt = false;
        if (in_smem) {
#pragma unroll 4
          for (int64_t d = 0; d < k; ++d) {
            const double v = x[d];
            le &= v <= upper[d];
            lt |= v < lower[d];
          }
        } else {
#pragma unroll 4
          for (int64_t d = 0; d < k; ++d) {
            const double v = x[d], cd = cand[d];
            le &= v <= __dadd_rn(cd, eps);
            lt |= v < __dsub_rn(cd, eps);
          }
        }
        hit = le & lt;
      }
      found = __any_sync(kFull, hit);
    }
    if (lane == 0) out[i] = found;
  }
}

}  // namespace

extern "C" int pareto_dominated_wide(const double* rows, int64_t n,
                                     const double* cands, int64_t c, int k,
                                     double eps, int64_t seg, bool* out,
                                     unsigned long long* queue,
                                     cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  int blocks = 0;
  cudaError_t err = resident_blocks(wide_kernel, 0, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t work = (c + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(work < blocks ? work : blocks);
  wide_kernel<<<grid, kThreads, 0, stream>>>(rows, n, cands, c, k, eps, seg,
                                             out, queue);
  return cudaGetLastError();
}
"""


#: Text variants of the source for ``--wide``: (old, new) patches.
WIDE_VARIANTS = {
    "as_built": [],
    # the wide screen answers at once (False, no survivor), so that the
    # wide split finds none: the floor of the two launches
    "noop": [("  if (k == 0) {\n    for (int64_t i = int64_t{blockIdx.x}",
              "  if (k >= 0) {\n    for (int64_t i = int64_t{blockIdx.x}")],
    # pass 1 as a float32 compare of the high words (timing only: the same
    # order for positive values, a stand-in for a float32 prefilter), to
    # see what the float64 compares cost
    "hi_word": [("            le &= v[j] <= up ? ~0u : ~(1u << (u * J + j));\n",
                 "            le &= __int_as_float(__double2hiint(v[j])) <= "
                 "__int_as_float(__double2hiint(up)) ? ~0u : ~(1u << (u * J + "
                 "j));\n")],
    # knock-out (timing only): no unit tests a row, every slot walks every
    # chunk and every screen group its stream
    "no_units": [
        ("      const unsigned found = wide_unit<kStaged>(\n          x, rs, "
         "ds, k, eps, cand, ub, lb, 2 * k, r_lo, r_hi, open, 0, len);\n",
         "      const unsigned found = 0;\n"),
        ("      const unsigned found = wide_unit<kStaged>(\n          x, rs, "
         "ds, k, eps, member, sm.upper[warp][0], sm.lower[warp][0],\n"
         "          kWideStage, r_lo, r_hi, open, u_lo, u_hi);\n",
         "      const unsigned found = 0;\n")],
}

#: Builds of ``--wide`` timed but not held to the verdicts.
WIDE_TIMING_ONLY = {"noop", "no_units", "hi_word"}

#: ``--wide``'s traced build: each block's start and end on the card's
#: global timer (the wide screen's and the wide split's persistent blocks)
#: and counts of the chunks the split's blocks walked, the screen's units
#: and the split's items (one atomic each): (marker, code inserted after
#: it).
WIDE_TRACE = [
    ("#include <stdint.h>\n",
     "__device__ unsigned long long g_screen[1 << 14][2];\n"
     "__device__ unsigned long long g_split[1 << 12][2];\n"
     "__device__ unsigned long long g_count[8];\n"
     "__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int len_max = wide_screen_rows(k), pitch = len_max + 1;\n",
     "  const unsigned long long t_start = now_ns();\n"),
    ("      if (g >= groups) break;\n",
     "      if (lane == 0) atomicAdd(&g_count[1], 1ull);\n"),
    ("    __syncthreads();                   // every unit is done with the "
     "chunk\n",
     "    if (threadIdx.x == 0) atomicAdd(&g_count[0], 1ull);\n"),
    ("  const SplitItems work = split_items(s_count, n, wide_chunk_rows(k));"
     "\n", "  const unsigned long long t_start = now_ns();\n"),
    ("      live = lo < hi && !__ldcg(done + slot);\n    }\n    if (live) {\n"
     "      sm.cand[threadIdx.x] = cand;\n",
     "    }\n    if (threadIdx.x == 0) atomicAdd(&g_count[3], 1ull);\n"
     "    if (live) {\n"),
]
_ITEM = ("    const int64_t slab = item % slabs, part = item / slabs;\n"
         "    const int64_t p_lo = part * part_rows, p_hi = min(p_lo + "
         "part_rows, n);\n    const int64_t slot = slab * slab_size + "
         "threadIdx.x;\n")
#: The traced build's patches that record a block's end where it leaves.
WIDE_TRACE_ENDS = [
    ("    if (item >= items) break;\n" + _ITEM,
     "    if (item >= items) {\n"
     "      if (threadIdx.x == 0 && blockIdx.x < (1 << 12)) {\n"
     "        g_split[blockIdx.x][0] = t_start;\n"
     "        g_split[blockIdx.x][1] = now_ns();\n      }\n"
     "      break;\n    }\n" + _ITEM),
    ("    const int64_t s = sm.slab;\n    if (s >= slabs) break;\n",
     "    const int64_t s = sm.slab;\n    if (s >= slabs) {\n"
     "      if (threadIdx.x == 0 && blockIdx.x < (1 << 14)) {\n"
     "        g_screen[blockIdx.x][0] = t_start;\n"
     "        g_screen[blockIdx.x][1] = now_ns();\n      }\n"
     "      break;\n    }\n"),
]
WIDE_TRACE_API = """
extern "C" int trace_read(unsigned long long* screen,
                          unsigned long long* split,
                          unsigned long long* count) {
  int err = cudaMemcpyFromSymbol(screen, g_screen, sizeof(g_screen));
  if (!err) err = cudaMemcpyFromSymbol(split, g_split, sizeof(g_split));
  if (!err) err = cudaMemcpyFromSymbol(count, g_count, sizeof(g_count));
  return err;
}
extern "C" int trace_zero() {
  static unsigned long long z[1 << 15];
  int err = cudaMemcpyToSymbol(g_screen, z, sizeof(g_screen));
  if (!err) err = cudaMemcpyToSymbol(g_split, z, sizeof(g_split));
  if (!err) err = cudaMemcpyToSymbol(g_count, z, sizeof(g_count));
  return err;
}
"""
WIDE_TRACE_NAMES = ["chunks", "screen_groups", "unused", "items"]


def traced_text(text: str) -> str:
    """The source with ``WIDE_TRACE`` patched in."""
    for marker, code in WIDE_TRACE:
        if text.count(marker) != 1:
            raise SystemExit(f"marker not found once: {marker!r}")
        text = text.replace(marker, marker + code)
    return patched(text, WIDE_TRACE_ENDS) + WIDE_TRACE_API


def trace_summary(screen, split) -> dict:
    """Spans from the traced blocks' timer stamps (ns -> us): the kernel's
    span, the blocks' durations, and when the last block started."""
    import numpy as np
    out = {}
    for name, t in (("screen", screen), ("split", split)):
        t = t[t[:, 0] > 0]
        if not len(t):
            continue
        t0 = t[:, 0].min()
        dur = (t[:, 1] - t[:, 0]) / 1e3
        out[name] = {"blocks": int(len(t)),
                     "span_us": float((t[:, 1].max() - t0) / 1e3),
                     "block_us_median": float(np.median(dur)),
                     "block_us_max": float(dur.max()),
                     "last_start_us": float((t[:, 0].max() - t0) / 1e3)}
    return out


def wide_main() -> int:
    import subprocess

    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch.core as C
    from repro_torch.core import batched as B
    from repro_torch.core import pareto as P
    from repro_torch.core import subcircuits as sc
    from repro_torch.kernels import build
    from repro_torch.kernels.pareto_dominated import kernel as K
    from repro_torch.kernels.timing import FLUSH_BYTES, SPIN_CYCLES
    from repro_torch.parallel import spec_sweep_mesh
    sys.path.append(str(HERE.parent / "tests"))
    from torch_dominance_cases import wide_tie_points

    text = (build.CSRC / "pareto_dominated.cu").read_text()
    texts = {name: patched(text, patches)
             for name, patches in WIDE_VARIANTS.items()}
    texts["one_warp"] = OLD_WIDE
    texts["traced"] = traced_text(text)
    with ThreadPoolExecutor(len(texts)) as pool:   # one nvcc per build
        paths = dict(zip(texts, pool.map(
            lambda kv: build.build_source(
                "pareto_dominated_wide_" + re.sub(r"\W", "_", kv[0]),
                kv[1]), texts.items())))
    libs = {name: K.bind(paths[name]) for name in WIDE_VARIANTS}
    old = ctypes.CDLL(str(paths["one_warp"]))
    old.pareto_dominated_wide.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_double, ctypes.c_int64] +
        [ctypes.c_void_p] * 3)
    old.pareto_dominated_wide.restype = ctypes.c_int
    traced = K.bind(paths["traced"])
    traced.trace_read.argtypes = [ctypes.c_void_p] * 3

    eps, mesh = P.PARETO_EPS, spec_sweep_mesh(["cuda:0"] * 4)
    sets = {}
    objs = wide_tie_points(8192, 12, eps, 0)
    with cs._recorded_dominance() as calls:
        B.pareto_mask(objs, device="cuda")
        P.nondominated_mask_sharded(objs, mesh=mesh)
    sets["8192x12"] = calls
    objs = wide_tie_points(65_536, 16, eps, 0)
    with cs._recorded_dominance() as calls:
        B.pareto_mask(objs, device="cuda")
    sets["65536x16"] = calls

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def timed(fn):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn()
        e1.record()
        return out, (e0, e1)

    def new(lib, call):
        return lambda: run(K, lib, call)[0]

    def one_warp(call):
        rows, cands, eps_, seg = call[:4]

        def go():
            out = torch.empty(cands.shape[0], dtype=torch.bool,
                              device="cuda")
            queue = torch.zeros(1, dtype=torch.int64, device="cuda")
            err = old.pareto_dominated_wide(
                rows.data_ptr(), rows.shape[0], cands.data_ptr(),
                cands.shape[0], rows.shape[1], eps_, seg, out.data_ptr(),
                queue.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the one-warp wide kernel: CUDA error "
                                   f"{err}")
            return out
        return go

    failed = 0
    others = ["one_warp"] + [v for v in WIDE_VARIANTS if v != "as_built"]
    for label, calls in sets.items():
        sums = {v: [] for v in ["as_built"] + others}
        for call in calls:
            rows, cands, _, seg, _, got = call
            fns = {v: new(libs[v], call) for v in WIDE_VARIANTS}
            fns["one_warp"] = one_warp(call)
            for fn in fns.values():          # warm-up, first loads
                fn()
            runs = {v: [] for v in fns}
            for _ in range(ROUNDS):
                for a in others:
                    for v in ("as_built", a, a, "as_built"):
                        runs[v].append(timed(fns[v]))
                torch.cuda.synchronize()
            times = {}
            for v, rs in runs.items():
                if v not in WIDE_TIMING_ONLY:
                    failed += sum(not torch.equal(out, got) for out, _ in rs)
                ms = [e0.elapsed_time(e1) for _, (e0, e1) in rs]
                sums[v].append(ms)
                times[v] = {"ms": float(np.median(ms)), "ms_min": min(ms),
                            "ms_max": max(ms)}
            stats = run(K, libs["as_built"], call)[1]
            torch.cuda.synchronize()
            traced.trace_zero()
            failed += not torch.equal(run(K, traced, call)[0], got)
            torch.cuda.synchronize()
            stamps = [np.zeros((1 << 14, 2), dtype=np.uint64),
                      np.zeros((1 << 12, 2), dtype=np.uint64),
                      np.zeros(8, dtype=np.uint64)]
            traced.trace_read(*(a.ctypes.data for a in stamps))
            trace = {**trace_summary(stamps[0].astype(np.int64),
                                     stamps[1].astype(np.int64)),
                     **dict(zip(WIDE_TRACE_NAMES,
                                (int(x) for x in stamps[2])))}
            print(json.dumps({
                "set": label, "n": rows.shape[0], "c": cands.shape[0],
                "k": rows.shape[1], "seg": seg,
                "not_dominated": int((~got).sum()),
                "survivors": int(stats["survivors"].item()),
                **times["as_built"], "trace": trace,
                "builds": {v: times[v] for v in others}}), flush=True)
        for v, per_call in sums.items():
            total = [sum(t) for t in zip(*per_call)]
            print(json.dumps({
                "set": label, "build": v, "calls": len(per_call),
                "ms_sum_median": float(np.median(total)),
                "ms_sum_min": min(total), "ms_sum_max": max(total)}),
                  flush=True)

    # the control: the compiler's frontier calls at k = 3 (A2, A3)
    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
    from repro_torch.core.shardspec import design_space_sweep_many_sharded
    sweeps = C.design_space_sweep_many(specs, tech, config=config,
                                       device="cuda")
    with cs._recorded_dominance() as a2:
        [s.frontier_indices() for s in sweeps]
    sharded = design_space_sweep_many_sharded(specs, tech, config=config,
                                              mesh=spec_sweep_mesh(),
                                              mode="jit")
    with cs._recorded_dominance() as a3:
        [s.frontier_indices() for s in sharded]
    def wide_route(fn):
        # the binding with no objective count left to the narrow kernels
        def go():
            saved, K.MAX_OBJECTIVES = K.MAX_OBJECTIVES, 0
            try:
                return fn()
            finally:
                K.MAX_OBJECTIVES = saved
        return go

    for row, calls in (("A2", a2), ("A3", a3)):
        per_call = {"narrow": [], "wide": []}
        for call in calls:
            fns = {"narrow": new(libs["as_built"], call)}
            fns["wide"] = wide_route(fns["narrow"])
            runs = {v: [] for v in fns}
            for fn in fns.values():
                fn()
            for _ in range(ROUNDS):
                for v in ("narrow", "wide", "wide", "narrow"):
                    runs[v].append(timed(fns[v]))
            torch.cuda.synchronize()
            for v, rs in runs.items():
                failed += sum(not torch.equal(out, call[5]) for out, _ in rs)
                per_call[v].append([e0.elapsed_time(e1)
                                    for _, (e0, e1) in rs])
        for v, times in per_call.items():
            total = [sum(t) for t in zip(*times)]
            print(json.dumps({
                "control": row, "route": v, "calls": len(calls),
                "ms_sum_median": float(np.median(total)),
                "ms_sum_min": min(total), "ms_sum_max": max(total)}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0



def main() -> int:
    if "--wide" in sys.argv[1:]:
        return wide_main()
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch.core as C
    from repro_torch.core import subcircuits as sc
    from repro_torch.core.shardspec import design_space_sweep_many_sharded
    from repro_torch.kernels import build
    from repro_torch.kernels.pareto_dominated import kernel as K
    from repro_torch.kernels.pareto_dominated import passes
    from repro_torch.kernels.timing import FLUSH_BYTES
    from repro_torch.parallel import spec_sweep_mesh

    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
    sweeps = C.design_space_sweep_many(specs, tech, config=config,
                                       device="cuda")
    with cs._recorded_dominance() as a2:
        [s.frontier_indices() for s in sweeps]
    sharded = design_space_sweep_many_sharded(specs, tech, config=config,
                                              mesh=spec_sweep_mesh(),
                                              mode="jit")
    with cs._recorded_dominance() as a3:
        [s.frontier_indices() for s in sharded]

    text = (build.CSRC / "pareto_dominated.cu").read_text()
    texts = {name: patched(text, patches)
             for name, patches in VARIANTS.items()}
    texts.update((path, Path(path).read_text()) for path in sys.argv[1:])
    texts["counted"] = counted_text(text)
    with ThreadPoolExecutor(len(texts)) as pool:   # one nvcc per build
        paths = dict(zip(texts, pool.map(
            lambda kv: build.build_source(
                "pareto_dominated_" + re.sub(r"\W", "_", kv[0]), kv[1]),
            texts.items())))
    libs = {name: K.bind(paths[name])
            for name in texts if name != "counted"}
    counted = K.bind(paths["counted"])
    counted.probe_read.argtypes = [ctypes.c_void_p]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    other = [v for v in libs if v != "as_built"]
    failed = 0
    for row, calls in (("A2", a2), ("A3", a3)):
        sums = {v: [] for v in libs}
        for call in calls:
            rows, cands, _, seg, _, got = call
            split = "split" in passes(rows.shape[0], cands.shape[0], seg)
            for v in libs:               # warm-up, and the first use's load
                run(K, libs[v], call)
            runs = {v: [] for v in libs}
            for _ in range(ROUNDS):
                for a in other:
                    for v in ("as_built", a, a, "as_built"):
                        runs[v].append(run(K, libs[v], call, flush))
                torch.cuda.synchronize()
            times = {}
            for v, rs in runs.items():
                if v not in TIMING_ONLY:
                    failed += sum(not torch.equal(out, got)
                                  for out, _ in rs)
                ev = [s["events"] for _, s in rs]
                screen = [e[0].elapsed_time(e[1]) for e in ev]
                split_ms = [e[1].elapsed_time(e[2]) for e in ev]
                total = [s + t for s, t in zip(screen, split_ms)]
                sums[v].append(total)
                times[v] = {"screen_ms": float(np.median(screen)),
                            "split_ms": float(np.median(split_ms))
                            if split else None,
                            "ms": float(np.median(total)),
                            "ms_min": min(total), "ms_max": max(total)}
            stats = runs["as_built"][-1][1]
            counts = [0] * 8
            if split:
                counted.probe_zero()
                failed += not torch.equal(run(K, counted, call)[0], got)
                buf = np.zeros(8, dtype=np.uint64)
                counted.probe_read(buf.ctypes.data)
                counts = [int(x) for x in buf]
            print(json.dumps({
                "row": row, "n": rows.shape[0], "c": cands.shape[0],
                "seg": seg, "not_dominated": int((~got).sum()),
                **times["as_built"],
                "survivors": int(stats["survivors"].item()),
                "variants": {v: times[v] for v in other},
                **dict(zip(NAMES, counts[:len(NAMES)]))}), flush=True)
        for v, per_call in sums.items():
            # per round position: the sum over the calls of one run each
            total = [sum(t) for t in zip(*per_call)]
            print(json.dumps({
                "row": row, "variant": v, "calls": len(per_call),
                "ms_sum_median": float(np.median(total)),
                "ms_sum_min": min(total), "ms_sum_max": max(total),
                "sum_of_medians": float(sum(np.median(t)
                                            for t in per_call))}),
                  flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
