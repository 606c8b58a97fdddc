#!/usr/bin/env python3
"""Where the compiler's device time goes, checkout against checkout: the
traced device busy of the lattice roll-up and of the frontier masks, split
into kernels and copies.

    python3 probes/compiler_split.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
such as ``build/``).  For each ROOT in the order given, in a process of
its own that imports that checkout's ``src/repro_torch``, on one CUDA card:
``design_space_sweep_many`` of the four scenario specs at the full
registered lattice and ``frontier_indices()`` of each sweep, once to warm
up (and build the kernels), three times untimed by the tracer (host wall,
synchronised), then once under ``torch.profiler``: the union of the device
intervals in all and by kind (``kernel``; ``memcpy``, host <-> device
copies; ``memset``), with their counts, by ``chip_smoke._device_split``
of this checkout whatever ROOT is measured.  Prints one JSON line per run,
prefixed with the run's index and ROOT.  Give the roots as parent, change,
change, parent to read each difference against the spread of a repeat.
Exits non-zero if any run fails.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import sys
sys.path.insert(0, {here!r})
sys.path.insert(0, {repo!r})
sys.path.insert(0, {src!r})
import compiler_split
compiler_split.measure()
"""


def measure() -> None:
    """The measurement of one checkout (the process imports its src)."""
    import torch

    import repro_torch.core as C
    from chip_smoke import _device_split
    from repro_torch.core import subcircuits as sc

    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
    state = {}

    def sweep():
        state["sweeps"] = C.design_space_sweep_many(specs, tech,
                                                    config=config,
                                                    device="cuda")

    def frontiers():
        return [s.frontier_indices() for s in state["sweeps"]]

    out = {}
    for name, fn in (("sweep", sweep), ("frontiers", frontiers)):
        fn()                                        # warm-up and builds
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        _device_split(lambda: None)                 # the tracer's start-up
        out[name] = {"wall_s": walls, "busy": _device_split(fn)[1]}
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    failed = 0
    for i, root in enumerate(roots):
        root = str(Path(root).resolve())
        code = RUN.format(src=str(Path(root) / "src"), here=str(here),
                          repo=str(here.parent))
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"[{i} {root}] {line}", end="", flush=True)
        if proc.wait() != 0:
            print(f"[{i} {root}] exit {proc.returncode}", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
