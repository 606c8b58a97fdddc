"""Workload-aware macro selection on the torch port: sweep the compiler
across macro geometries and pick the best accelerator configuration for
each assigned model architecture — the paper's system-level story
(vision/language/cloud macros want different PPA corners).

    PYTHONPATH=src python examples/torch_pareto_sweep.py --arch granite-moe-1b-a400m
    PYTHONPATH=src python examples/torch_pareto_sweep.py --device cpu

It prints what ``examples/pareto_sweep.py`` prints.  Each geometry's
frontier comes from the batched search over the whole design lattice on
``--device`` (the CUDA card unless ``--device cpu``), whose frontier is the
scalar search's.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import (MacroSpec, SubcircuitLibrary,  # noqa: E402
                              accelerator_report,
                              calibrated_tech_for_reference, gemm_inventory,
                              mso_search)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--n-macros", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device of the search (default: the CUDA "
                         "card; 'cpu' for the CPU)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    gemms = gemm_inventory(cfg)
    tech = calibrated_tech_for_reference()
    scl = SubcircuitLibrary(tech).build()

    print(f"workload: {args.arch} — {len(gemms)} GEMM classes, "
          f"{sum(g.macs for g in gemms) / 1e9:.2f} GMAC per token-batch")
    best = None
    for h, w in ((32, 32), (64, 64), (128, 128), (256, 256)):
        spec = MacroSpec(h=h, w=w, mcr=2, int_precisions=(4, 8),
                         fp_precisions=("FP8",), f_mac_hz=800e6,
                         f_wupdate_hz=800e6, vdd=0.9)
        res = mso_search(spec, scl, tech, backend="batched",
                         device=args.device)
        eff = max(res.frontier, key=lambda p: p.tops_per_w_1b["int_lo"])
        rep = accelerator_report(gemms, eff, n_macros=args.n_macros, ib=8,
                                 wb=8)
        s = rep.summary()
        print(f"  {h:3d}x{w:<3d} {eff.design.name():42s} "
              f"tops={s['effective_tops']:7.3f} util={s['avg_util']:.3f} "
              f"energy_uj={s['energy_uj']:10.1f} area={s['area_mm2']:6.1f}mm2")
        score = s["effective_tops"] / max(s["energy_uj"], 1e-9)
        if best is None or score > best[0]:
            best = (score, h, w, eff.design.name(), s)
    _, h, w, name, s = best
    print(f"\nbest macro for {args.arch}: {h}x{w} [{name}] — "
          f"{s['effective_tops']} TOPS @ {s['energy_uj']} uJ/batch")


if __name__ == "__main__":
    main()
