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
    ("cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks) {\n",
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
                    "int64_t{kThreads}")],
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


def main() -> int:
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
