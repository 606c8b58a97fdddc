"""Recompute the ``cost`` of dry-run records from their stored op logs
(no re-tracing; the port of the JAX package's
``repro/roofline/reanalyze.py``, which re-walks ``<tag>.hlo.gz``):

    PYTHONPATH=src python -m repro_torch.roofline.reanalyze <dir>
"""

import json
import sys
from pathlib import Path

from .op_cost import analyze, read_ops


def main():
    d = Path(sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun")
    for j in sorted(d.glob("*.json")):
        rec = json.loads(j.read_text())
        ops = d / (j.stem + ".ops.gz")
        if not rec.get("ok") or not ops.exists():
            continue
        rec["cost_raw"] = rec.get("cost_raw", rec.get("cost"))
        rec["cost"] = analyze(read_ops(ops))
        j.write_text(json.dumps(rec, indent=1))
        print("reanalyzed", j.stem)


if __name__ == "__main__":
    main()
