#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. device    print the card's name and power limit, build every CUDA
               kernel of the port from ``src/repro_torch/csrc``;
  2. compiler  the compiler's batched main path on the four scenario specs
               at the full registered lattice (155,520 points per spec):
               ``mso_search_many`` and ``design_space_sweep_many(...)
               .frontier_indices()`` on the card, held bit for bit against
               the same calls with ``device="cpu"`` and the search results
               against the scalar oracle;
  3. mac       the ``dcim_mac`` kernels at the qwen3-4b GEMM shapes
               (``gemm_inventory``, seq 256) plus ragged shapes, driven
               through the public wrappers with launch counts reset just
               before and read just after; every output held equal to its
               plain torch version on the card, one output to the bit-serial
               DCIM reference; each kernel timed with CUDA events beside its
               plain version, ``torch._int_mm`` and its bound;
  4. report    one ``{"kernels": [...]}`` line, then as the last line
               ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one, and when it does not
sit at the root of a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

# Ragged shapes of the JAX package's kernel tests, checked for equality
# only; times and bounds are reported over the qwen3-4b GEMMs.
RAGGED = (("ragged_8x16x8", 8, 16, 8), ("ragged_130x96x200", 130, 96, 200),
          ("ragged_1x512x64", 1, 512, 64))


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels.build import CSRC, build_library
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = list(pool.map(build_library, names))
    log(f"device: built {names} in {time.perf_counter() - t0:.3f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {lib.name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 2. compiler
# ---------------------------------------------------------------------------


def _ppa_repr(p) -> str:
    """A MacroPPA as text: ``repr`` of a float round-trips, so equal text
    means equal bits (NaN included)."""
    return repr(dataclasses.asdict(p))


def _ppa_arrays(ppa) -> dict:
    out = {k: getattr(ppa, k) for k in ("mac", "sa", "ofu", "crit", "fmax",
                                        "meets", "area", "latency",
                                        "tops_1b", "tops_mm2")}
    for group in ("breakdown", "e_cycle", "tops_w"):
        for k, v in getattr(ppa, group).items():
            out[f"{group}.{k}"] = v
    return out


def _same_array(a, b) -> bool:
    """Equal shape, type and bits (float64 compared as its bit patterns)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float64:
        a, b = a.view(np.uint64), b.view(np.uint64)
    return bool(np.array_equal(a, b))


def _device_profile(fn) -> tuple[float, float, int]:
    """``(wall_s, device_busy_s, kernels)`` of one traced ``fn()`` call:
    the union of the CUDA kernel intervals ``torch.profiler`` records, over
    the host wall time of the traced window (tracing overhead included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return wall, busy_us * 1e-6, len(spans)


def phase_compiler() -> dict:
    import torch

    import repro_torch.core as C
    from repro_torch.core import subcircuits as sc

    tech = C.calibrated_tech_for_reference()
    scl = C.SubcircuitLibrary(tech).build()
    scen = C.scenario_specs()
    names, specs = list(scen), list(scen.values())
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)

    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    log(f"compiler: cuda context set-up {time.perf_counter() - t0:.3f} s")
    runs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        results = C.mso_search_many(specs, scl, tech, config=config,
                                    device=dev)
        t1 = time.perf_counter()
        sweeps = C.design_space_sweep_many(specs, tech, config=config,
                                           device=dev)
        t2 = time.perf_counter()
        fronts = [s.frontier_indices() for s in sweeps]
        t3 = time.perf_counter()
        runs[dev] = (results, sweeps, fronts)
        walls[dev] = {"design_space_sweep_many": t2 - t1,
                      "frontier_indices": t3 - t2}
        log(f"compiler[{dev}]: mso_search_many {t1 - t0:.3f} s, "
            f"design_space_sweep_many {t2 - t1:.3f} s, "
            f"frontier_indices {t3 - t2:.3f} s")

    (res_g, sw_g, fr_g), (res_c, sw_c, fr_c) = runs["cuda"], runs["cpu"]
    for i, name in enumerate(names):
        n_points = len(sw_g[i].lattice)
        check(n_points == 155_520, f"{name}: lattice has {n_points} points")
        arrays_g, arrays_c = _ppa_arrays(sw_g[i].ppa), _ppa_arrays(sw_c[i].ppa)
        check(list(arrays_g) == list(arrays_c), f"{name}: array sets differ")
        for k in arrays_g:
            check(_same_array(arrays_g[k], arrays_c[k]),
                  f"{name}: PPA array {k} differs between cuda and cpu")
        check(fr_g[i] == fr_c[i],
              f"{name}: frontier indices differ between cuda and cpu")
        check(len(fr_g[i]) > 0, f"{name}: empty sweep frontier")
        rg, rc = res_g[i], res_c[i]
        check(rg.n_evaluated == rc.n_evaluated
              and [_ppa_repr(p) for p in rg.explored]
              == [_ppa_repr(p) for p in rc.explored]
              and [_ppa_repr(p) for p in rg.frontier]
              == [_ppa_repr(p) for p in rc.frontier],
              f"{name}: search results differ between cuda and cpu")
        # The batched replay against the port's scalar Algorithm 1 oracle:
        # the same designs explored and on the frontier, in the same order.
        # (Their floats are held in tests/test_torch_core.py: the scalar
        # roll-up's area ``sum()`` is compensated on Python >= 3.12.)
        oracle = C.mso_search(specs[i], scl, tech)
        check(oracle.n_evaluated == rg.n_evaluated
              and [p.design.name() for p in oracle.explored]
              == [p.design.name() for p in rg.explored]
              and [p.design.name() for p in oracle.frontier]
              == [p.design.name() for p in rg.frontier],
              f"{name}: cuda search differs from the scalar oracle")
        finite = np.isfinite(sw_g[i].ppa.area[sw_g[i].lattice.valid]).all()
        check(bool(finite), f"{name}: non-finite area on a valid point")
        log(f"compiler: {name}: {n_points} points, "
            f"{int((sw_g[i].lattice.valid & sw_g[i].ppa.meets).sum())} "
            f"feasible, sweep frontier {len(fr_g[i])}, search frontier "
            f"{len(rg.frontier)} of {rg.n_evaluated} explored; cuda == cpu "
            f"bit for bit, search == scalar oracle")

    # Where the time goes on the card, traced apart from the checked runs:
    # the lattice roll-up (A1 plus its host work) and the frontier masks
    # (A2).  The busy share is taken against the untraced wall time of the
    # same call above; a first traced call absorbs the tracer's start-up.
    _device_profile(lambda: torch.zeros(1, device="cuda"))
    for what, fn in (
            ("design_space_sweep_many", lambda: C.design_space_sweep_many(
                specs, tech, config=config, device="cuda")),
            ("frontier_indices", lambda: [s.frontier_indices()
                                          for s in sw_g])):
        wall, busy, n = _device_profile(fn)
        log(f"compiler[cuda, traced]: {what}: device busy {busy:.6f} s over "
            f"{n} kernels, {100 * busy / walls['cuda'][what]:.3f}% of the "
            f"untraced wall {walls['cuda'][what]:.6f} s (traced wall "
            f"{wall:.6f} s)")
    return {"language": res_g[names.index("language")]}


# ---------------------------------------------------------------------------
# 3. mac
# ---------------------------------------------------------------------------


def _time_ms(fn, reps: int = 20) -> float:
    """Median device time of one ``fn()`` call, by CUDA events, with the L2
    cache flushed before each call (a model step finds its weights cold).
    A device-side spin after the flush lets the host queue ``fn``'s launches
    before the start event runs, so host overhead between the events is
    not counted as device time."""
    import torch
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)           # ~1 ms at the card's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _bound_ms(m: int, k: int, n: int, out_bytes: int, epilogue: bool
              ) -> tuple[float, str]:
    """Least time on the card: bytes (each input read once, the output
    written once) over HBM rate vs operations over their peak rate."""
    nbytes = m * k + k * n + out_bytes * m * n + (4 * (m + n) if epilogue
                                                   else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / INT8_OPS_PER_S + (2 * m * n / F32_OPS_PER_S
                                              if epilogue else 0.0)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_mac(language) -> list[dict]:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import mac_operands_from_numpy
    from repro_torch.core import gemm_inventory
    from repro_torch.kernels.dcim_mac import dcim_matmul, dcim_matmul_int
    from repro_torch.kernels.dcim_mac import ref

    gemms = [(g.name, g.m, g.k, g.n)
             for g in gemm_inventory(get_config("qwen3-4b"), seq=256)]
    rng = np.random.default_rng(SEED)
    ops = {}
    for name, m, k, n in gemms + list(RAGGED):
        ops[name] = mac_operands_from_numpy(
            rng.integers(-128, 128, (m, k), dtype=np.int8),
            rng.integers(-128, 128, (k, n), dtype=np.int8),
            rng.uniform(0.01, 2.0, m).astype(np.float32),
            rng.uniform(0.01, 2.0, n).astype(np.float32), device="cuda")

    # -- the main path: every shape through the public wrappers -------------
    dcim_matmul.launches = 0
    dcim_matmul_int.launches = 0
    outs = {}
    for name, (a, w, asc, wsc) in ops.items():
        outs[name] = (dcim_matmul_int(a, w),
                      dcim_matmul(a, w, asc, wsc, out_dtype=torch.float32),
                      dcim_matmul(a, w, asc, wsc, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    launches = {"dcim_mac_int": dcim_matmul_int.launches,
                "dcim_mac": dcim_matmul.launches}
    log(f"mac: launches on the main path {launches}")
    check(launches["dcim_mac_int"] == len(ops)
          and launches["dcim_mac"] == 2 * len(ops),
          f"launch counts {launches} for {len(ops)} shapes")

    # -- held against the plain versions on the card -------------------------
    err = {"dcim_mac_int": 0.0, "dcim_mac": 0.0}
    for name, (a, w, asc, wsc) in ops.items():
        got_i, got_f, got_b = outs[name]
        want_i = ref.dcim_matmul_int_ref(a, w)
        want_f = ref.dcim_matmul_ref(a, w, asc, wsc, out_dtype=torch.float32)
        want_b = ref.dcim_matmul_ref(a, w, asc, wsc,
                                     out_dtype=torch.bfloat16)
        for label, got, want in (("int32", got_i, want_i),
                                 ("f32", got_f, want_f),
                                 ("bf16", got_b, want_b)):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {label}: {got.shape}/{got.dtype} vs "
                  f"{want.shape}/{want.dtype}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} {label}: non-finite output")
            key = "dcim_mac_int" if label == "int32" else "dcim_mac"
            diff = (got.double() - want.double()).abs().max().item()
            err[key] = max(err[key], diff)
            check(torch.equal(got, want),
                  f"{name} {label}: kernel differs from its plain version "
                  f"(max |diff| {diff})")
    log("mac: every kernel output equals its plain version on the card "
        "(int32, f32, bf16; qwen3-4b and ragged shapes)")

    # -- the bit-serial DCIM semantics at the chosen macro's precision -------
    chosen = max(language.frontier, key=lambda p: p.tops_per_w_1b["int_lo"])
    bits = max(chosen.design.ofu_precisions
               or chosen.design.spec.int_precisions)
    lo, hi = ref.quant_range(bits)
    a, w = ops["wk"][0], ops["wk"][1]
    if bits < 8:
        a = a.clamp(lo, hi)
        w = w.clamp(lo, hi)
    serial = ref.dcim_matmul_bitserial_ref(a, w, bits, bits)
    got = dcim_matmul_int(a, w) if bits < 8 else outs["wk"][0]
    check(torch.equal(got, serial),
          f"wk: kernel differs from the INT{bits} bit-serial reference")
    log(f"mac: wk equals the bit-serial reference at INT{bits} "
        f"(language macro {chosen.design.name()})")

    # -- times beside the plain version, torch._int_mm and the bound --------
    rows = {"dcim_mac_int": [], "dcim_mac": []}
    for name, m, k, n in gemms:
        a, w, asc, wsc = ops[name]
        lib = _time_ms(lambda: torch._int_mm(a, w))
        rows["dcim_mac_int"].append(dict(
            gemm=name, m=m, k=k, n=n,
            ms=_time_ms(lambda: dcim_matmul_int(a, w)),
            plain_ms=_time_ms(lambda: ref.dcim_matmul_int_ref(a, w)),
            library_ms=lib, bound=_bound_ms(m, k, n, 4, False)))
        for dt, nb in ((torch.float32, 4), (torch.bfloat16, 2)):
            rows["dcim_mac"].append(dict(
                gemm=f"{name}/{str(dt).split('.')[1]}", m=m, k=k, n=n,
                ms=_time_ms(lambda: dcim_matmul(a, w, asc, wsc,
                                                out_dtype=dt)),
                plain_ms=_time_ms(lambda: ref.dcim_matmul_ref(
                    a, w, asc, wsc, out_dtype=dt)),
                library_ms=lib, bound=_bound_ms(m, k, n, nb, True)))
    for kname, rs in rows.items():
        for r in rs:
            log(f"mac: {kname} {r['gemm']} {r['m']}x{r['k']}x{r['n']}: "
                f"kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
                f"torch._int_mm {r['library_ms']:.6f} ms, bound "
                f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")

    src = "src/repro_torch/csrc/dcim_mac.cu"
    replaces = {
        "dcim_mac_int": "src/repro/kernels/dcim_mac/kernel.py:128",
        "dcim_mac": "src/repro/kernels/dcim_mac/kernel.py:86",
    }
    kernels = []
    for kname, rs in rows.items():
        bound = sum(r["bound"][0] for r in rs)
        by_bytes = sum(r["bound"][0] for r in rs if r["bound"][1] == "bytes")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": err[kname],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
            # one torch call computes the int32 product; none computes the
            # product with the fused per-row x per-column dequant
            "library_ms": (sum(r["library_ms"] for r in rs)
                           if kname == "dcim_mac_int" else None),
        })
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    phase_device()
    t1 = time.perf_counter()
    chosen = phase_compiler()
    t2 = time.perf_counter()
    kernels = phase_mac(chosen["language"])
    t3 = time.perf_counter()
    log(f"phases: device {t1 - t0:.3f} s, compiler {t2 - t1:.3f} s, "
        f"mac {t3 - t2:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
