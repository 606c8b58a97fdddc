#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s kernel phases of several checkouts in turns, so
that two versions of the kernels are compared on one card in one call.

    python3 probes/ab_phases.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
such as ``build/``).  For each ROOT in the order given, in a process of
its own, it imports that checkout's ``chip_smoke.py`` and ``src/`` and
runs its device phase (builds every kernel, prints registers and spills),
the compiler's ``mso_search_many`` on the card (the mac phase's bit-serial
check needs its language macro), then the mac, csa and ssm phases, whose
lines carry every time, bound and check.  Every line is prefixed with the
run's index and ROOT.  Give the roots as parent, change, change, parent to
read each difference against the spread of a repeat.  Needs one CUDA card;
exits non-zero if any run fails.
"""

import subprocess
import sys
from pathlib import Path

RUN = """
import sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import chip_smoke as c
import repro_torch.core as C
from repro_torch.core import subcircuits as sc
c.phase_device()
tech = C.calibrated_tech_for_reference()
specs = C.scenario_specs()
language = C.mso_search_many(
    list(specs.values()), C.SubcircuitLibrary(tech).build(), tech,
    config=C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS),
    device="cuda")[list(specs).index("language")]
_, wk = c.phase_mac(language)
c.phase_csa(wk)
c.phase_ssm()
"""


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    failed = 0
    for i, root in enumerate(roots):
        root = str(Path(root).resolve())
        code = RUN.format(src=str(Path(root) / "src"), root=root)
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
