#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix, found by name
under ``perfbench/`` (:mod:`perfbench.lib.manifest`).  The run builds the
port's model (``repro_torch``) with its weights drawn on the card from the
seed, prefills the first job and warms up (set-up), serves the traffic for
``--seconds`` (the window), and, with ``--trace 1``, traces a few more
steps with ``torch.profiler``.  Then it frees the program, checks the
served tokens against the plain float32 reference
(:mod:`perfbench.lib.judge`) and prints one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
its per-layer ones with ``--trace 1``), ``device``, ``breakdown`` (traced
runs) and, last, ``checks``: each number compared beside its limit, also
the last lines of standard error.

It needs the CUDA cards the cell asks for, and exits non-zero without a
result where they are missing, or where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()       # as near to the process start as can be

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot) is JAX's or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def build_config(config: dict):
    """The port's ``ArchConfig`` of a configuration file's ``port`` block."""
    import dataclasses

    from repro_torch.configs import MoECfg, SSMCfg, get_config

    port = dict(config["port"])
    base = get_config(port.pop("arch"))
    fields = {f.name for f in dataclasses.fields(base)}
    kw = {k: v for k, v in port.items() if k in fields}
    if "moe" in kw:
        kw["moe"] = MoECfg(**kw["moe"])
    if "ssm" in kw:
        kw["ssm"] = SSMCfg(**kw["ssm"])
    return base.replace(**kw)


def port_of(cfg, port: dict) -> dict:
    """A configuration's ``port`` block with every size the ``ArchConfig``
    ``cfg`` runs (the tests run smaller ones)."""
    import dataclasses

    out = {k: getattr(cfg, k) if hasattr(cfg, k) else v
           for k, v in port.items()}
    out["head_dim"] = cfg.hd
    for k in ("moe", "ssm"):
        if getattr(cfg, k) is not None:
            out[k] = dataclasses.asdict(getattr(cfg, k))
    return out


def _count(events: list, family, port: dict) -> None:
    for ev in events:
        if ev["kind"] == "decode":
            ev.update(family.decode_step(port, ev["tokens"], ev["filled"]))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, fault: str | None = None,
             control: bool = False, config=None) -> dict:
    """One run of ``cell``; returns the result object (module doc).
    ``config`` replaces the cell's ``ArchConfig`` (the tests run a small
    one on the CPU); ``fault`` breaks the timed path (the traffic kind's
    ``Pool``); ``control`` adds the control's readings and its verdict, by
    the same check (``info.control``)."""
    import torch

    from perfbench.lib import judge, manifest, trace as tracing
    from perfbench.lib.weights import draw, specs_of
    from repro_torch.models import get_model, model_class
    from repro_torch.serve import step  # noqa: F401  (imported here, with the rest)

    cfg = build_config(cell.config) if config is None else config
    traffic, rules = cell.traffic, cell.config["init"]
    family = cell.config["family"]
    Pool = manifest.load_kind(traffic).Pool
    counts = manifest.load_family("counts", family)
    reference = manifest.load_family("reference", family)
    port = port_of(cfg, cell.config["port"])
    ccfg = dict(cell.config, port=port)
    cuda = torch.device(device).type == "cuda"

    marks = [time.perf_counter()]

    def mark():
        if cuda:
            torch.cuda.synchronize(device)
        marks.append(time.perf_counter())

    with torch.no_grad():
        model = model_class(cfg)(cfg, device="meta")
        specs = specs_of(model)
        model.load_state_dict(draw(specs, rules, seed, device), strict=True,
                              assign=True)
        mark()
        pool = Pool(get_model(cfg), model, traffic, cfg.vocab, seed, device,
                    fault=fault)
        pool.start_job()
        mark()
        for _ in range(int(traffic.get("warmup_steps", 2))):
            pool.step()
        mark()
        # what set-up left is kept out of the window's garbage collections
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start

        t0 = time.perf_counter_ns()
        pool.jobs[-1].last_t = t0
        deadline = t0 + int(seconds * 1e9)
        events = []
        while True:
            ev = pool.step()
            if ev["t_end"] > deadline:
                break
            events.append(ev)
        tr = tracing.trace_steps(pool, int(traffic.get("trace_steps", 4))) \
            if trace else None

    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    served = pool.served()
    pool.free()
    del pool, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    _count(events, counts, port)
    if tr is not None:
        _count(tr["events"], counts, port)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec = {"setup_s": setup_s, "window_s": float(seconds), "events": events,
           "trace": tr, "peaks": manifest.load_json("peaks.json").get(kind),
           "matmul_substrings": manifest.load_json("kernel_classes.json")
           ["matmul"]["substrings"]}
    metrics = {}
    for m in cell.metrics(trace):
        v = manifest.load_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_check = time.perf_counter()
    res = judge.compare(reference, ccfg, cell.check, traffic, served,
                        lambda: draw(specs, rules, seed, device), seed,
                        device, control=control)
    t_check = time.perf_counter() - t_check
    compared, sound = judge.verdict(res, cell.check)
    window_jobs = {ev["job"] for ev in events}
    decode_steps = sum(ev["kind"] == "decode" for ev in events)
    # a request failed where its own reading of the check's first number
    # that has one per request (the widest gap, else the mean) is over
    # that number's limit; the others are readings of the whole sample
    name = next(n for n in compared if n in res["per_sequence"])
    failed = sum(v > compared[name][1] for v in res["per_sequence"][name])
    correct = (bool(events) and sound
               and all(math.isfinite(m["value"]) for m in metrics.values()))
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct),
           "attempted": sum(served[j][0].shape[0] for j in window_jobs),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        w0, w1 = tr["window_ns"]
        dev["busy_s"] = tracing.busy_ns(tr) / 1e9
        dev["window_s"] = (w1 - w0) / 1e9
        out["breakdown"] = tracing.breakdown(tr)
    parts = [b - a for a, b in zip([t_start] + marks, marks)]
    out["info"] = {"setup_s": setup_s, "setup_parts": dict(zip(
        ("start_and_imports", "weights", "first_prefill", "warmup"), parts)),
                   "check_s": t_check,
                   "decode_steps": decode_steps, "jobs": len(served),
                   "window_prefills_s": [(ev["t_end"] - ev["t0"]) / 1e9
                                         for ev in events
                                         if ev["kind"] == "prefill"],
                   "compared": {k: res[k] for k in ("job", "sequences",
                                                    "positions")}}
    out["info"]["readings"] = {k: res[k] for k in ("widest_gap", "mean_gap",
                                                   "p99_gap",
                                                   "seq_widest_median",
                                                   "mismatch_share")}
    if control:
        c_compared, c_correct = judge.verdict(res["control"], cell.check)
        out["info"]["control"] = {
            "readings": res["control"], "correct": c_correct,
            "checks": {name: {"value": v, "limit": limit}
                       for name, (v, limit) in c_compared.items()}}
    out["checks"] = {name: {"value": v, "limit": limit}
                     for name, (v, limit) in compared.items()}
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    import torch

    from perfbench.lib.manifest import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"run: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"run: {card_line()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
