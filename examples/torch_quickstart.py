"""Quickstart on the torch port: performance spec in, macro out.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. Define a MacroSpec (dimensions, precisions, MCR, target frequency, PPA
   preferences) — the compiler input of Fig. 2.
2. Build the calibrated 40nm tech model + Subcircuit Library (PPA LUTs).
3. Run the Multi-Spec-Oriented searcher (Algorithm 1) over the whole design
   lattice in one float64 pass on the device (``backend="batched"``) ->
   Pareto frontier.
4. Pick a design, print its PPA report, emit RTL, and *functionally verify*
   the synthesized adder tree at gate level.

It prints what ``examples/quickstart.py`` prints, but for the number of
designs evaluated: the batched search counts every lattice point, the
scalar one only the points its hierarchy visits.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (MacroSpec, SubcircuitLibrary,  # noqa: E402
                              calibrated_tech_for_reference, emit_verilog,
                              mso_search, tree_netlist, verify_tree)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the search (default: the CUDA "
                         "card; 'cpu' for the CPU)")
    args = ap.parse_args()

    spec = MacroSpec(h=64, w=64, mcr=2,
                     int_precisions=(4, 8), fp_precisions=("FP4", "FP8"),
                     f_mac_hz=800e6, f_wupdate_hz=800e6, vdd=0.9)
    print(f"spec: {spec.h}x{spec.w} MCR={spec.mcr} INT{spec.int_precisions} "
          f"FP{spec.fp_precisions} @ {spec.f_mac_hz / 1e6:.0f} MHz, "
          f"{spec.vdd} V")

    tech = calibrated_tech_for_reference()
    scl = SubcircuitLibrary(tech).build()
    print(f"subcircuit library: {len(scl)} characterized PPA records")

    res = mso_search(spec, scl, tech, backend="batched", device=args.device)
    print(f"\nMSO search: {res.n_evaluated} designs evaluated, "
          f"{len(res.frontier)} on the Pareto frontier:")
    for p in res.frontier:
        s = p.summary()
        print(f"  {s['design']:45s} fmax={s['fmax_mhz']:7.1f}MHz "
              f"area={s['area_mm2']:.4f}mm2 TOPS/W={s['tops_w_int_lo']:7.1f} "
              f"TOPS/mm2={s['tops_mm2']:5.1f}")

    # user selection: the most energy-efficient design meeting the spec
    chosen = max(res.frontier, key=lambda p: p.tops_per_w_1b["int_lo"])
    print(f"\nchosen: {chosen.design.name()}")
    print("  searcher audit trail:")
    for a in chosen.design.audit:
        print(f"    - {a}")

    rtl = emit_verilog(chosen)
    print(f"\nemitted RTL: {len(rtl.splitlines())} lines "
          f"(module dcim_macro)")

    nl = tree_netlist(chosen.design)
    ops = np.random.default_rng(0).integers(0, 2, size=(nl.n_inputs, 64)) * \
        np.random.default_rng(1).integers(-8, 8, size=(nl.n_inputs, 64))
    ok = verify_tree(nl, ops)
    print(f"gate-level functional verification of synthesized adder tree: "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
