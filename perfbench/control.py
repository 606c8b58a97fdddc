#!/usr/bin/env python3
"""Read a cell's comparison on several seeds, with its control or with a
timed path broken on purpose, in one process: the readings its limits are
set from.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds 11,12,13
    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds 11 \
        --faults state_unchanged,half_batch,token_altered

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``), then compares the served tokens with the plain float32
reference and reads the control on the same prompts and tokens: the same
reference computed in float8 e4m3, the precision below the
configuration's bfloat16 (:mod:`perfbench.lib.judge`).  The control's
numbers go through the same check as the program's, and its verdict is
printed beside them.  With ``--faults``, each seed runs once with each
fault (the traffic kind's ``Pool``) in place of the control.  One JSON
line per run; the benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (perfbench/run.py, beside this file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults to run in place of the "
                         "control")
    args = ap.parse_args(argv)
    run._fixed_caches()
    import torch

    from perfbench.lib.manifest import load_cell

    if not torch.cuda.is_available():
        print("control: no CUDA card is visible", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    print(f"control: {run.card_line()}", flush=True)
    t = T_PROCESS
    faults = [f for f in args.faults.split(",") if f] or [None]
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in faults:
            out = run.run_cell(cell, seed, args.seconds, False, "cuda:0", t,
                               control=fault is None, fault=fault)
            line = {"seed": seed, "fault": fault, "correct": out["correct"],
                    "checks": out["checks"],
                    "readings": out["info"]["readings"]}
            if fault is None:
                line["control_correct"] = out["info"]["control"]["correct"]
            line["metrics"] = {k: v["value"]
                               for k, v in out["metrics"].items()}
            line["info"] = out["info"]
            print(json.dumps(line), flush=True)
            t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
