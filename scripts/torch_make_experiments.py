"""Write ``<out>/EXPERIMENTS.md`` from the port's dry-run artifacts: the
dry-run matrix and the roofline tables of both production meshes, under a
header with the card figures the roofline uses.  Rerun after a sweep:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python scripts/torch_make_experiments.py [--out artifacts]

``--tuned DIR`` adds the tables of a ``--tuned`` sweep written there.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline import hw  # noqa: E402
from repro_torch.roofline.report import (dryrun_table,  # noqa: E402
                                         load_records, roofline_table,
                                         skip_table)


def header() -> str:
    return f"""\
# EXPERIMENTS — SynDCIM, torch/CUDA port

Generated by ``scripts/torch_make_experiments.py`` from the records of
``python -m repro_torch.launch.dryrun``.  Card model (``src/repro_torch/
roofline/hw.py``, NVIDIA's H100 SXM data sheet at 700 W):
{hw.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense,
{hw.HBM_BW / 1e12:.2f} TB/s HBM, {hw.HBM_PER_CHIP / 1e9:.0f} GB per card,
NVLink {hw.NVLINK_BW / 1e9:.0f} GB/s per card (both directions; a
collective's per-rank bytes are sent at half of it).  One rank is one
card.

## §Dry-run

Every (architecture x applicable shape) cell traced for rank 0 of a fake
process group on both production meshes (single-pod 16x16 = 256 ranks;
multi-pod 2x16x16 = 512 ranks): the port's own train step, prefill or
decode step, run on meta tensors, so nothing is allocated or computed on
any device.

Notes on the recorded numbers:
  * FLOPs, bytes and collective traffic come from the aten ops the step
    runs (``repro_torch/roofline/op_cost.py``): dots 2 x |result| x the
    contracted size, every op's operands and results as device bytes
    (views free; each eager op is a kernel of its own), the collectives'
    ring bytes per rank from the port's call log.  Every layer and every
    rematerialised block is an op of its own, so there are no trip counts.
  * Memory is the live storage bytes of this rank through the step: its
    parameter pieces, AdamW moments and batch (or decode state) as
    arguments, the peak above them as temporaries.  ``fits`` is the peak
    within one card's {hw.HBM_PER_CHIP / 1e9:.0f} GB.
  * The port gathers every weight whole before use (ZeRO-3 over every
    mesh axis) and does not shard activations, so each rank of the
    ``model`` axis repeats its data row's compute: ``useful/traced``
    shows it.
"""


ROOFLINE = """
## §Roofline

Terms per rank per step: compute = traced FLOPs / the bf16 rate, memory =
traced bytes / HBM bandwidth, collective = ring bytes / (NVLink / 2).
``useful/traced`` = MODEL_FLOPS / (traced FLOPs x ranks); ``roofline-MFU
bound`` = the MFU the step would reach at its dominant term.
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="artifacts/dryrun",
                    help="directory of the dry-run records")
    ap.add_argument("--tuned", default=None,
                    help="directory of a --tuned sweep's records")
    ap.add_argument("--out", default="artifacts",
                    help="directory EXPERIMENTS.md is written to")
    args = ap.parse_args(argv)

    base = load_records(Path(args.dryrun))
    n_ok = sum(1 for r in base.values() if r.get("ok"))
    out = [header(),
           f"### Matrix ({n_ok}/{len(base)} cells traced)\n",
           dryrun_table(base),
           "\n### Skipped cells\n", skip_table(), ROOFLINE,
           "### Single-pod (16x16 = 256 ranks)\n",
           roofline_table(base, "single"),
           "\n### Multi-pod (2x16x16 = 512 ranks)\n",
           roofline_table(base, "multi")]
    if args.tuned:
        opt = load_records(Path(args.tuned))
        n_ok = sum(1 for r in opt.values() if r.get("ok"))
        out += [f"\n## §Roofline — tuned overrides ({n_ok}/{len(opt)} "
                f"cells traced; ``--tuned``)\n",
                "### Single-pod (16x16 = 256 ranks)\n",
                roofline_table(opt, "single"),
                "\n### Multi-pod (2x16x16 = 512 ranks)\n",
                roofline_table(opt, "multi")]
    dest = Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    path = dest / "EXPERIMENTS.md"
    path.write_text("\n".join(out) + "\n")
    print(f"wrote {path}", len(path.read_text().splitlines()), "lines")
    return 0


if __name__ == "__main__":
    sys.exit(main())
