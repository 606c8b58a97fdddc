#!/usr/bin/env python3
"""Where the lattice roll-up kernel's (A1) time goes, source against
source: each source and variants of it with one part cut out, timed on the
compiler phase's operands.

    python3 probes/rollup_split.py SOURCE [SOURCE ...]

Each SOURCE is a ``lattice_rollup.cu``: this checkout's
(``src/repro_torch/csrc/lattice_rollup.cu``) or an earlier commit's,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/parent/src/repro_torch/csrc/lattice_rollup.cu``).  Every source
keeps the binding's C interface (``RollupArgs``, ``lattice_rollup``), so
one binding (``kernels/lattice_rollup/kernel.py``, its library swapped
through ``kernel.bind``) drives them all.  For each SOURCE in the order
given, on one CUDA card, built with the source's flags (``-fmad=false``),
the source as it is and each variant whose text it holds (every
replacement must match):

  as_is       the source;
  no_staging  the tables are not staged in shared memory (the outputs are
              wrong; the time is the kernel's without the staging);
  one_wave    (the fixed 1,056-block grid of the earlier kernel) 528
              blocks in all, one wave at 4 blocks of 256 threads per SM,
              instead of two waves;
  bounds_2    (the earlier kernel) ``__launch_bounds__(kThreads, 2)``:
              what the register cap has to do with its spill.

Prints, per build, its ptxas registers and spill bytes, then one JSON line
per run: the summed time of the two spec groups of the four scenario specs
(``chip_smoke._a1_groups``; CUDA events, L2 flushed, median of 20 calls
per group, ``chip_smoke._time_ms``) and, for ``as_is``, whether every
output equals the plain version (``batched._eval_kernel``) bit for bit.
Give the sources as parent, change, change, parent to read each difference
against the spread of a repeat.  Exits non-zero if an ``as_is`` build
differs from the plain version.
"""

import functools
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

_OLD_STAGING = """#pragma unroll
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
"""
_NEW_STAGING = ("  for (int base = 0; base < L.total; "
                "base += kThreads * kStage) {")

#: name -> alternatives, each a list of (old, new) text replacements; the
#: first alternative whose every ``old`` is in the source is applied.
VARIANTS = {
    "as_is": [[]],
    "no_staging": [[(_OLD_STAGING, "")],
                   [(_NEW_STAGING, _NEW_STAGING.replace("base < L.total",
                                                        "base < 0"))]],
    "one_wave": [[("constexpr int kBlocks = 1056;",
                   "constexpr int kBlocks = 528;")]],
    "bounds_2": [[("__launch_bounds__(kThreads)\n    rollup_kernel",
                   "__launch_bounds__(kThreads, 2)\n    rollup_kernel")]],
}


def variant_text(text: str, name: str) -> str | None:
    for edits in VARIANTS[name]:
        if all(old in text for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            return text
    return None


def main(sources: list[str]) -> int:
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import chip_smoke as c
    import repro_torch.core.engine as E
    from repro_torch.core import batched as B
    from repro_torch.core import subcircuits as sc
    import repro_torch.core as C
    from repro_torch.kernels import build
    from repro_torch.kernels.lattice_rollup import kernel as K

    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
    groups = c._a1_groups(specs, tech, config)
    ops = []
    for packed in groups:
        tabs, consts, e_ofu, e_align = packed.operands
        f64 = functools.partial(torch.as_tensor, dtype=torch.float64,
                                device="cuda")
        ops.append((E._gather_index(packed, torch.device("cuda")),
                    tuple(f64(t) for t in tabs), f64(consts), f64(e_ofu),
                    f64(e_align)))
    want = [B._eval_kernel(*o) for o in ops]
    bound, by = c._a1_bound_ms(groups)
    card = torch.cuda.get_device_name(0)
    lib_of = K._lib
    failed = 0
    for run, source in enumerate(sources):
        text = Path(source).read_text()
        for name in VARIANTS:
            vtext = variant_text(text, name)
            if vtext is None:
                continue
            path = build.build_source(f"rollup_probe_{name}", vtext,
                                      build.SOURCE_FLAGS["lattice_rollup"])
            use = build.ptxas_report(path.with_suffix(".log").read_text())
            K._lib = functools.cache(lambda p=path: K.bind(p))
            try:
                exact = None
                if name == "as_is":
                    exact = all(_same(B.eval_lattice(*o), w)
                                for o, w in zip(ops, want))
                    failed += not exact
                ms = sum(c._time_ms(lambda o=o: B.eval_lattice(*o))
                         for o in ops)
            finally:
                K._lib = lib_of
            print(json.dumps({"run": run, "source": source, "variant": name,
                              "ms": ms, "bound_ms": bound, "bound_by": by,
                              "exact": exact, "ptxas": use, "card": card}),
                  flush=True)
    return 1 if failed else 0


def _same(got: dict, want: dict) -> bool:
    import torch

    def bits(t):
        return t.contiguous().view(torch.int64)

    pairs = [(got[k], want[k]) for k in ("mac_base", "ofu_base", "area",
                                         "e_cycle")]
    pairs += [(got["breakdown"][k], v) for k, v in want["breakdown"].items()]
    return all(g.shape == w.shape and torch.equal(bits(g), bits(w))
               for g, w in pairs)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
