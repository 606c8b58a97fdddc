"""Pre-fill the torch port's frontier cache tiers ahead of a deployment.

Synthesizes the ``scenario_specs()`` x preference-grid product (every
scenario spec at every requested grid resolution, optionally plus the
exhaustive sweep that leaves per-axis slice records behind) with
``repro_torch.service`` and publishes the frontiers into the given store, so
a fleet's first macro selection is warm on every host, with zero engine
executions:

    PYTHONPATH=src python scripts/torch_warm_cache.py \\
        --registry /mnt/shared/syndcim-registry --resolutions 3,4,5 --sweep

Point ``--registry`` at shared storage to warm a whole fleet, or ``--store``
at a local directory to warm one host (both may be given).  The artifacts
and their content addresses are byte-compatible with
``scripts/warm_cache.py``'s, so a store either script warms serves both
packages.  ``--autotune-kernels`` additionally pre-fills the kernel
tile-autotune artifacts (``repro_torch.kernels.autotune``, keyed on the
card, torch and CUDA versions) into the registry, so serving hosts launching
with ``tile_config="auto"`` never pay a tuning sweep.  Re-running is cheap
and idempotent: already-published addresses are cache hits and are skipped
(content addressing), so a cron'd warm-up converges to a no-op.  Claim files
coordinate concurrent warmers: two hosts warming the same registry split
the misses instead of duplicating them.

The fused passes and the tuning run on the CUDA card; ``--device cpu`` runs
the passes on the CPU and tunes the kernels' plain versions (such tunings
are keyed to the CPU and never taken for the card).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.multispec import scenario_specs  # noqa: E402
from repro_torch.service import (ArtifactRegistry,  # noqa: E402
                                 FrontierCache, SynthesisRequest,
                                 SynthesisService)

#: The stock serving tile sweep of ``--autotune-kernels default``.
DEFAULT_TUNE_TARGETS = [("dcim_mac", (128, 512, 512)),
                        ("dcim_mac", (512, 512, 512)),
                        ("ssm_scan", (1024, 256)),
                        ("ssm_scan", (4096, 256)),
                        ("csa_tree", (256, 512)),
                        ("csa_tree", (1024, 512))]


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--registry", default=None, metavar="PATH",
                    help="fleet-shared artifact-registry root on shared "
                         "storage")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="local frontier-store directory")
    ap.add_argument("--resolutions", default="4", metavar="R1,R2,...",
                    help="preference-grid resolutions to warm (default: 4, "
                         "the serving default)")
    ap.add_argument("--scenarios", default=None, metavar="NAME,...",
                    help="scenario subset (default: all of "
                         "scenario_specs())")
    ap.add_argument("--sweep", action="store_true",
                    help="also warm the exhaustive design-space sweep per "
                         "scenario, leaving per-axis slice records so the "
                         "fleet's next scoped recalibration re-synthesizes "
                         "incrementally")
    ap.add_argument("--mode", default="auto",
                    help="execution mode for the fused miss passes "
                         "(default: auto)")
    ap.add_argument("--autotune-kernels", default=None, metavar="SHAPES",
                    help="also pre-fill kernel tile-autotune artifacts into "
                         "--registry: comma-separated kernel:DxDx... entries "
                         "(e.g. dcim_mac:512x512x512,ssm_scan:4096x256), or "
                         "'default' for a stock serving sweep")
    ap.add_argument("--autotune-iters", type=int, default=3,
                    help="timing repetitions per tile candidate")
    ap.add_argument("--device", default=None,
                    help="torch device of the fused passes and the tuning "
                         "(default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args()

    if args.registry is None and args.store is None:
        ap.error("nothing to warm: pass --registry and/or --store")
    if args.autotune_kernels and args.registry is None:
        ap.error("--autotune-kernels persists through the shared registry; "
                 "pass --registry")
    resolutions = [int(r) for r in args.resolutions.split(",") if r.strip()]

    specs = scenario_specs()
    if args.scenarios is not None:
        wanted = [s.strip() for s in args.scenarios.split(",") if s.strip()]
        unknown = sorted(set(wanted) - set(specs))
        if unknown:
            ap.error(f"unknown scenarios {unknown}; have {sorted(specs)}")
        specs = {k: specs[k] for k in wanted}

    registry = (None if args.registry is None
                else ArtifactRegistry(args.registry))
    service = SynthesisService(
        mode=args.mode, device=args.device,
        cache=FrontierCache(store_dir=args.store, registry=registry))

    requests = [SynthesisRequest(spec=spec, resolution=r, tag=name)
                for name, spec in specs.items() for r in resolutions]
    if args.sweep:
        requests += [SynthesisRequest(spec=spec, kind="sweep", tag=name)
                     for name, spec in specs.items()]

    t0 = time.time()
    responses = service.serve(requests)
    elapsed = time.time() - t0

    filled = sum(1 for r in responses if r.served_from == "engine")
    warm = len(responses) - filled
    print(f"warm_cache: {len(responses)} addresses "
          f"({len(specs)} scenarios x {len(resolutions)} resolutions"
          + (" + sweeps" if args.sweep else "") + ") in {:.1f}s — "
          .format(elapsed)
          + f"{filled} synthesized, {warm} already warm "
          f"(on {service.device})")
    for section, counters in service.telemetry().items():
        line = " ".join(f"{k}={v}" for k, v in counters.items())
        print(f"warm_cache: {section}: {line}")

    if args.autotune_kernels:
        from repro_torch.kernels import autotune as kernel_autotune
        if args.autotune_kernels == "default":
            targets = DEFAULT_TUNE_TARGETS
        else:
            targets = []
            for entry in args.autotune_kernels.split(","):
                kernel, _, dims = entry.strip().partition(":")
                targets.append((kernel, tuple(int(d)
                                              for d in dims.split("x"))))
        t0 = time.time()
        for kernel, shape in targets:
            res = kernel_autotune.autotune(kernel, shape,
                                           iters=args.autotune_iters,
                                           registry=registry,
                                           device=service.device)
            print(f"warm_cache: autotune {kernel} "
                  f"{'x'.join(map(str, shape))} -> {res.winner.as_dict()} "
                  f"({res.time_us:.0f}us, "
                  f"nondefault={res.picked_nondefault})")
        print(f"warm_cache: {len(targets)} tile artifacts in "
              f"{time.time() - t0:.1f}s — serving hosts resolve them via "
              f"tile_config='auto'")


if __name__ == "__main__":
    main()
