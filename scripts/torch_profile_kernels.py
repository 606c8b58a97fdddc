"""Profile the port's kernels: copy vs compute vs fused.

Times the copy-only / compute-only / fused skeletons of each kernel
(``repro_torch.kernels.profile``) over a shape sweep, classifies each point
bandwidth- vs compute-bound, and reports the roofline fraction (how much of
the fused time the slower side accounts for: 1.0 means the cheaper side is
fully hidden):

    PYTHONPATH=src python scripts/torch_profile_kernels.py --kernel all
    PYTHONPATH=src python scripts/torch_profile_kernels.py \\
        --kernel dcim_mac --shapes 256x2560x4096,256x9728x2560 --iters 5
    PYTHONPATH=src python scripts/torch_profile_kernels.py --json kp.json
    PYTHONPATH=src python scripts/torch_profile_kernels.py --smoke \\
        --device cpu --json kp.json

By default the skeletons run as CUDA kernels on the card, timed with CUDA
events (L2 flushed, the best of ``--iters``), and the script fails where
there is no card.  ``--device cpu`` runs their plain versions: the same
plumbing and report, with host times that say nothing of the card.  The
``--json`` artifact (schema ``syndcim-kernel-profile/v1``, byte-compatible
with ``scripts/profile_kernels.py``'s) carries the aggregate fraction that
``repro_torch.roofline.dcim.dcim_serving_bound(kernel_fraction=...)``
takes (``fraction_from_profile_artifact``).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.profile import (fraction_from_profiles,  # noqa: E402
                                         profile_kernel, profiles_payload)
from repro_torch.kernels.tiles import KERNELS, TileConfig  # noqa: E402

#: Default shape sweep per kernel (serving-ish sizes; trimmed in --smoke).
DEFAULT_SHAPES = {
    "dcim_mac": [(128, 512, 512), (512, 512, 512)],
    "ssm_scan": [(1024, 256), (4096, 256)],
    "csa_tree": [(256, 512), (1024, 512)],
}

SMOKE_SHAPES = {
    "dcim_mac": [(32, 128, 128)],
    "ssm_scan": [(128, 128)],
    "csa_tree": [(600, 256)],
}


def parse_shapes(text: str) -> list[tuple[int, ...]]:
    return [tuple(int(d) for d in s.split("x")) for s in text.split(",") if s]


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", default="all",
                    help=f"one of {', '.join(KERNELS)}, or 'all'")
    ap.add_argument("--shapes", default=None, metavar="MxKxN,...",
                    help="comma-separated 'x'-joined shapes (only with a "
                         "single --kernel); default: a per-kernel sweep")
    ap.add_argument("--iters", type=int, default=3,
                    help="timing repetitions per skeleton (min taken)")
    ap.add_argument("--depth", type=int, default=None,
                    help="override the pipeline depth")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (CI: plumbing only)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the CUDA "
                         "card")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the profiles as a schema'd JSON "
                         "artifact (syndcim-kernel-profile/v1)")
    args = ap.parse_args()

    kernels = list(KERNELS) if args.kernel == "all" else [args.kernel]
    for k in kernels:
        if k not in KERNELS:
            ap.error(f"unknown kernel {k!r}; have {', '.join(KERNELS)}")
    if args.shapes and len(kernels) != 1:
        ap.error("--shapes needs a single --kernel")

    shape_table = SMOKE_SHAPES if args.smoke else DEFAULT_SHAPES
    tc = TileConfig(depth=args.depth) if args.depth else None

    profiles = []
    hdr = (f"{'kernel':9s} {'shape':>18s} {'copy_us':>10s} {'compute_us':>11s} "
           f"{'fused_us':>10s} {'bound':>9s} {'roofline':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for kernel in kernels:
        shapes = (parse_shapes(args.shapes) if args.shapes
                  else shape_table[kernel])
        for shape in shapes:
            p = profile_kernel(kernel, shape, tile_config=tc,
                               iters=args.iters, device=args.device)
            profiles.append(p)
            mark = "" if p.compute_measured else "*"
            print(f"{p.kernel:9s} {'x'.join(map(str, p.shape)):>18s} "
                  f"{p.t_copy_us:10.1f} {p.t_compute_us:10.1f}{mark:1s} "
                  f"{p.t_fused_us:10.1f} {p.bound:>9s} "
                  f"{p.roofline_fraction:8.3f}")
    print("-" * len(hdr))
    print(f"aggregate roofline fraction (geomean): "
          f"{fraction_from_profiles(profiles):.3f}"
          f"   (* = compute derived as fused - copy)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(profiles_payload(profiles), f, indent=2,
                      sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
