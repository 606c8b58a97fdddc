"""Dry-run and roofline tables from dry-run records (the port of the JAX
package's ``repro/roofline/report.py``).  After a sweep:

    PYTHONPATH=src python -m repro_torch.roofline.report artifacts/dryrun
    PYTHONPATH=src python -m repro_torch.roofline.report --paired DIR

The roofline terms model one H100 per rank (:mod:`.hw`: bf16 tensor-core
rate, HBM bandwidth, NVLink for the collectives) from each record's
per-rank counts (:mod:`repro_torch.launch.dryrun`); no card ran them.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..configs import SHAPES, ShapeCfg, applicable_shapes, get_config, \
    list_archs
from . import hw


def model_flops_per_step(arch: str, shape_name) -> float:
    """6·N·T (train), 2·N·T (prefill) or 2·N·B (decode) with N the active
    parameters; ``shape_name`` a key of ``SHAPES`` or a ``ShapeCfg``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def load_records(artdir: Path) -> dict[tuple, dict]:
    out = {}
    for p in sorted(artdir.glob("*.json")):
        rec = json.loads(p.read_text())
        out[(rec.get("arch"), rec.get("shape"), rec.get("mesh"))] = rec
    return out


def fmt_bytes(b: float) -> str:
    if b >= 1e9:
        return f"{b / 1e9:.2f}G"
    if b >= 1e6:
        return f"{b / 1e6:.1f}M"
    return f"{b / 1e3:.0f}K"


def roofline_terms(rec: dict) -> dict:
    c = rec["cost"]
    t_c = c["flops_per_device"] / hw.PEAK_BF16_FLOPS
    t_m = c["bytes_per_device"] / hw.HBM_BW
    t_x = hw.collective_time_s(c["coll_bytes_per_device"])
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    shape = SHAPES.get(rec["shape"]) or ShapeCfg(
        rec["shape"], rec["seq_len"], rec["global_batch"], rec["kind"])
    mf = model_flops_per_step(rec["arch"], shape)
    ranks = rec["devices"]
    useful = mf / (c["flops_per_device"] * ranks) if c["flops_per_device"] \
        else 0
    bound = max(t_c, t_m, t_x)
    mfu = (mf / ranks / hw.PEAK_BF16_FLOPS) / bound if bound else 0.0
    return {"t_c": t_c, "t_m": t_m, "t_x": t_x, "dom": dom, "mf": mf,
            "useful": useful, "mfu_bound": mfu, "bound_s": bound}


def dryrun_table(records: dict) -> str:
    lines = ["| arch | shape | mesh | trace_s | peak/rank (fits 80 GB) | "
             "GFLOP/rank | HBM GB/rank | coll MB/rank | top collectives |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), rec in sorted(records.items()):
        if not rec.get("ok"):
            err = rec.get("error", "").strip().splitlines()
            lines.append(f"| {arch} | {shape} | {mesh} | FAILED | | | | | "
                         f"{(err[-1] if err else '')[:60]} |")
            continue
        c = rec["cost"]
        mem = rec.get("memory", {})
        cc = sorted(c["coll_counts"].items(),
                    key=lambda kv: -kv[1]["bytes"])[:2]
        ccs = "; ".join(f"{k}x{int(v['count'])}={fmt_bytes(v['bytes'])}"
                        for k, v in cc)
        fits = "yes" if mem.get("fits") else "no"
        lines.append(
            f"| {arch} | {shape} | {mesh} | {rec.get('trace_s', '?')} | "
            f"{fmt_bytes(mem.get('total_bytes_per_device', 0))} ({fits}) | "
            f"{c['flops_per_device'] / 1e9:.1f} | "
            f"{c['bytes_per_device'] / 1e9:.2f} | "
            f"{c['coll_bytes_per_device'] / 1e6:.1f} | {ccs} |")
    return "\n".join(lines)


def roofline_table(records: dict, mesh: str = "single") -> str:
    lines = ["| arch | shape | t_compute | t_memory | t_collective | "
             "bottleneck | MODEL_FLOPS | useful/traced | roofline-MFU bound |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), rec in sorted(records.items()):
        if m != mesh or not rec.get("ok"):
            continue
        r = roofline_terms(rec)
        lines.append(
            f"| {arch} | {shape} | {r['t_c'] * 1e3:.2f} ms | "
            f"{r['t_m'] * 1e3:.2f} ms | {r['t_x'] * 1e3:.2f} ms | "
            f"**{r['dom']}** | {r['mf']:.2e} | {r['useful']:.3f} | "
            f"{r['mfu_bound']:.3f} |")
    return "\n".join(lines)


def paired_tables(records: dict) -> str:
    """The dry-run and roofline columns in one table, the two production
    meshes side by side (``single / multi`` in each cell), one row per
    (arch, shape); the bottleneck column names each mesh's dominant
    term."""
    cells = sorted({(a, s) for a, s, _ in records})
    rows = ["| arch | shape | trace s | peak GB/rank (fits 80 GB) | "
            "GFLOP/rank | HBM GB/rank | coll MB/rank | t_compute ms | "
            "t_memory ms | t_collective ms | bottleneck | useful/traced | "
            "roofline-MFU bound |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch, shape in cells:
        recs = [records.get((arch, shape, m), {}) for m in ("single",
                                                            "multi")]
        if not all(r.get("ok") for r in recs):
            rows.append(f"| {arch} | {shape} | FAILED |" + " |" * 10)
            continue
        cs = [r["cost"] for r in recs]
        ts = [roofline_terms(r) for r in recs]

        def pair(vals, fmt):
            return " / ".join(format(v, fmt) for v in vals)

        fits = "/".join("yes" if r["memory"]["fits"] else "no"
                        for r in recs)
        doms = "/".join(dict.fromkeys(t["dom"] for t in ts))
        rows.append(
            f"| {arch} | {shape} | {pair([r['trace_s'] for r in recs], '')}"
            f" | {pair([r['memory']['total_bytes'] / 1e9 for r in recs], '.2f')}"
            f" ({fits}) | "
            f"{pair([c['flops_per_device'] / 1e9 for c in cs], '.0f')} | "
            f"{pair([c['bytes_per_device'] / 1e9 for c in cs], '.0f')} | "
            f"{pair([c['coll_bytes_per_device'] / 1e6 for c in cs], '.0f')}"
            f" | {pair([t['t_c'] * 1e3 for t in ts], '.1f')} | "
            f"{pair([t['t_m'] * 1e3 for t in ts], '.1f')} | "
            f"{pair([t['t_x'] * 1e3 for t in ts], '.1f')} | {doms} | "
            f"{pair([t['useful'] for t in ts], '.3f')} | "
            f"{pair([t['mfu_bound'] for t in ts], '.4f')} |")
    return "\n".join(rows)


def skip_table() -> str:
    lines = ["| arch | skipped shape | reason |", "|---|---|---|"]
    for arch in list_archs():
        cfg = get_config(arch)
        have = set(applicable_shapes(cfg))
        for s in SHAPES:
            if s not in have:
                lines.append(f"| {arch} | {s} | full-attention arch: 500k "
                             f"dense-KV decode is quadratic-history; spec "
                             f"says skip (DESIGN.md §5) |")
    return "\n".join(lines)


def main():
    args = [a for a in sys.argv[1:] if a != "--paired"]
    artdir = Path(args[0] if args else "artifacts/dryrun")
    records = load_records(artdir)
    if "--paired" in sys.argv[1:]:
        print(paired_tables(records))
        return
    n_ok = sum(1 for r in records.values() if r.get("ok"))
    print(f"## Dry-run matrix ({n_ok}/{len(records)} cells traced)\n")
    print(dryrun_table(records))
    print("\n### Skipped cells\n")
    print(skip_table())
    print("\n## Roofline (single-pod 16x16 = 256 ranks)\n")
    print(roofline_table(records, "single"))
    print("\n## Roofline (multi-pod 2x16x16 = 512 ranks)\n")
    print(roofline_table(records, "multi"))


if __name__ == "__main__":
    main()
