#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. device    print the card's name and power limit, build every CUDA
               kernel of the port from ``src/repro_torch/csrc``: the
               hand-written sources and the ``csa_tree`` register kernels
               generated for the row counts this run uses (one first,
               alone, for its first-use build time), all in parallel;
               print each kernel's registers and spill bytes from its
               ptxas report (a spill in a ``csa_tree`` or ``dcim_mac``
               kernel fails the run, as do a ``dcim_mac`` TMA kernel whose
               wgmma pipeline ptxas serialized or whose registers are not
               the 168 its ``setmaxnreg`` budget assumes);
  2. compiler  the compiler's batched main path on the four scenario specs
               at the full registered lattice (155,520 points per spec):
               ``mso_search_many`` and ``design_space_sweep_many(...)
               .frontier_indices()`` on the card, held bit for bit against
               the same calls with ``device="cpu"`` and the search results
               against the scalar oracle; the bounds of its two device
               kernels (A1 roll-up, A2 frontier masks);
  3. mac       the ``dcim_mac`` kernels at the qwen3-4b GEMM shapes
               (``gemm_inventory``, seq 256) plus ragged shapes and an
               aligned square one, driven through the public wrappers with
               launch counts reset just before and read just after: per
               route, every qwen3-4b GEMM and the square on the TMA route
               (``pipelined``), the ragged shapes on the ``grid`` route;
               each GEMM's strips and K split printed; every output held
               equal to its plain torch version on the card, one output to
               the bit-serial DCIM reference; each kernel timed with CUDA
               events beside its plain version, ``torch._int_mm`` and its
               bound;
  4. csa       the ``csa_tree`` kernels on the qwen3-4b wk GEMM executed on
               the scenario specs' 64-row macro: the 40 K-chunk product
               stacks (64 x 262,144) through ``csa_tree_sum`` (rows route),
               the same product cut into the 10 K-chunks of a 256-row macro
               (256 x 262,144, the tall rows route) and the whole-K stack
               (2560 x 262,144) through the tiled route, plus ragged and
               wrapping stacks with both compressor settings (129 to 512
               rows on the tall rows route); every output equal to the
               plain version, the three reductions equal to
               ``dcim_matmul_int(a, w)`` bit for bit; times beside the
               plain version, ``torch.sum`` and the bound;
  5. ssm       the ``ssm_scan`` kernels on one zamba2-1.2b Mamba2 layer's
               SSD state (64 heads x 64 x 64 = 262,144 columns) over 1024
               steps, and at (1024, 256), (4096, 256) and (1000, 300),
               each with the chunk split (S, L) it runs: depths 1 to 4
               equal bit for bit to one another and to the chunked plain
               version, each within the JAX package's tolerance of the
               sequential plain version; each depth's time beside the
               plain version and the bound;
  6. autotune  the tile autotuner on the card for the warm-cache script's
               default targets (each winner within its exactness gate),
               then one ``tile_config="auto"`` call of each entry point,
               which must read the tuner's memo;
  7. report    one ``{"kernels": [...]}`` line, then as the last line
               ``{"ok": true, "device": {...}}``.

Each of phases 3-5 sets its kernels' launch counts to 0 just before its
main path and reads them just after; every kernel must have launched.

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
# INT32 word operations: 64 INT32 lanes per SM (Hopper architecture white
# paper) x 132 SMs x 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# float64 operations outside the tensor cores: 64 FP64 lanes per SM, the
# data sheet's 34 TFLOP/s counting an FMA as two
FP64_OPS_PER_S = 64 * 132 * 1.98e9

# Ragged shapes of the JAX package's kernel tests (the grid route: rows
# TMA cannot describe, or fewer than 64 tokens) and an aligned square
# M == N shape on the TMA route (a row scale read as a column scale would
# show), checked for equality only; times and bounds are reported over the
# qwen3-4b GEMMs.
RAGGED = (("ragged_8x16x8", 8, 16, 8), ("ragged_130x96x200", 130, 96, 200),
          ("ragged_1x512x64", 1, 512, 64))
SQUARE = (("square_256x512x256", 256, 512, 256),)

# The csa phase's ragged and wrapping stacks (H, N): one row, past the
# whole-rows limit twice (tiled route), 129 to 512 rows (the rows route's
# tall register kernels), and 77 rows of int32 extremes.
CSA_RAGGED = ((1, 5), (600, 300), (513, 1000), (129, 1000), (256, 1000),
              (300, 1000), (512, 1000), (77, 999))
# The scenario specs' macro height, and a 256-row macro's (MacroSpec(h=256))
CSA_MACRO_ROWS = 64
CSA_TALL_MACRO_ROWS = 256


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


def csa_register_kernels() -> set[tuple[int, bool]]:
    """(rows, use_compressors) of every ``csa_tree`` register kernel this
    run launches: the rows route at each stack of at most
    ``CSA_MAX_ROWS`` rows, the tiled route at the default tile, and the
    autotuner's candidate tiles."""
    from repro_torch.kernels.tiles import CSA_MAX_ROWS, DEFAULT_TILES
    from repro_torch.kernels.tiles import tile_space
    both = (True, False)
    out = {(CSA_MACRO_ROWS, True), (CSA_TALL_MACRO_ROWS, True)}
    out |= {(h, c) for h, _ in CSA_RAGGED if h <= CSA_MAX_ROWS for c in both}
    out |= {(DEFAULT_TILES["csa_tree"].bh, c) for c in both}
    out |= {(tc.bh, True) for kernel, shape in TUNE_TARGETS
            if kernel == "csa_tree" for tc in tile_space(kernel, shape)}
    return out


def phase_device() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels.build import (CSRC, build_library, ptxas_report,
                                          wgmma_serialized)
    from repro_torch.kernels.csa_tree.kernel import register_library

    t0 = time.perf_counter()
    first = register_library(CSA_MACRO_ROWS, True)
    log(f"device: first-use build of the generated {CSA_MACRO_ROWS}-row "
        f"csa_tree register kernel alone: {time.perf_counter() - t0:.3f} s")
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    generated = sorted(csa_register_kernels() - {(CSA_MACRO_ROWS, True)})
    jobs = [lambda n=n: build_library(n) for n in names]
    jobs += [lambda r=r: register_library(*r) for r in generated]

    def timed(job):
        t = time.perf_counter()
        return job(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(timed, jobs))
    log(f"device: built {names} and {len(generated)} more generated "
        f"csa_tree kernels (rows, compressors) {generated} in parallel in "
        f"{time.perf_counter() - t0:.3f} s")
    log("device: each build's wall time in the parallel batch: "
        + ", ".join(f"{lib.name} {secs:.3f} s" for lib, secs in built))
    libs = [first] + [lib for lib, _ in built]
    for lib in libs:
        report = ptxas_report(lib.with_suffix(".log").read_text())
        check(bool(report), f"no ptxas report for {lib.name}")
        for fn, use in report.items():
            log(f"  {lib.name}: {fn}: {use['registers']} registers, spill "
                f"stores {use['spill_stores']} B, spill loads "
                f"{use['spill_loads']} B")
            check(not lib.name.startswith(("libcsa_tree", "libdcim_mac"))
                  or use["spill_stores"] == use["spill_loads"] == 0,
                  f"{lib.name} spills")
            if lib.name.startswith("libdcim_mac") and "tma" in fn:
                check(use["registers"] == 168,
                      f"{fn}: {use['registers']} registers, not the 168 "
                      "its setmaxnreg budget assumes")
        serial = wgmma_serialized(lib.with_suffix(".log").read_text())
        check(not serial, f"{lib.name}: ptxas serialized the wgmma "
              f"pipeline of {sorted(serial)}")


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
    a1, a2 = _a1_bound_ms(specs, tech, config), _a2_bound_ms(sw_g)
    log(f"compiler: bounds on the card: A1 _eval_kernel (4 specs) "
        f"{a1[0]:.6f} ms ({a1[1]}), A2 chunk_dominated (4 frontiers) "
        f"{a2[0]:.6f} ms ({a2[1]})")
    return {"language": res_g[names.index("language")]}


def _a1_bound_ms(specs, tech, config) -> tuple[float, str]:
    """Least time of the lattice roll-up (A1, ``batched._eval_kernel``) over
    the engine's spec groups: the int64 gather indices (shared by a group),
    the per-spec tables and the float64 outputs (mac_base, ofu_base, area,
    the five gathered area terms, one energy per mode) each moved once,
    against its float64 adds and multiplies (8 per point plus 9 per mode)
    at the FP64 rate."""
    import repro_torch.core.engine as E

    plan = E.plan(specs, tech, config=config, device="cpu")
    nbytes = ops = 0
    for group in plan.groups:
        packed = E.pack_group([plan.lattices[i] for i in group],
                              [plan.tables[i] for i in group])
        n = len(packed.idx[0])
        tabs, consts, e_ofu, e_align = packed.operands
        lanes, modes = e_ofu.shape[:2]
        nbytes += 8 * (len(packed.idx) * n + sum(t.size for t in tabs)
                       + consts.size + e_ofu.size + e_align.size
                       + lanes * n * (8 + modes))
        ops += lanes * n * (8 + 9 * modes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _a2_bound_ms(sweeps) -> tuple[float, str]:
    """Least time of the frontier masks (A2, ``pareto.chunk_dominated``):
    two float64 compares (``<=`` and ``<`` with the eps band) per objective
    per pair of feasible points, against the objectives read once and the
    mask written once."""
    nbytes = ops = 0
    for sw in sweeps:
        n = int((sw.lattice.valid & sw.ppa.meets).sum()) \
            or int(sw.lattice.valid.sum())
        k = sw.objectives().shape[1]
        nbytes += 8 * n * k + n
        ops += 2 * k * n * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.kernels.dcim_mac import (dcim_matmul, dcim_matmul_int,
                                              mac_plan, mac_route, ref)

    gemms = [(g.name, g.m, g.k, g.n)
             for g in gemm_inventory(get_config("qwen3-4b"), seq=256)]
    for name, m, k, n in gemms:
        p = mac_plan(m, k, n)
        log(f"mac: plan {name} {m}x{k}x{n}: {p.m_strips} x {p.n_strips} "
            f"strips of 256 tokens x 128 columns, K split {p.splits} "
            f"(stages {p.stage_ranges}), {p.blocks} blocks")
    rng = np.random.default_rng(SEED)
    ops = {}
    for name, m, k, n in gemms + list(RAGGED) + list(SQUARE):
        ops[name] = mac_operands_from_numpy(
            rng.integers(-128, 128, (m, k), dtype=np.int8),
            rng.integers(-128, 128, (k, n), dtype=np.int8),
            rng.uniform(0.01, 2.0, m).astype(np.float32),
            rng.uniform(0.01, 2.0, n).astype(np.float32), device="cuda")

    # -- the main path: every shape through the public wrappers -------------
    routes = {name: mac_route(a.shape[0], a.shape[1], w.shape[1],
                              a.data_ptr(), w.data_ptr())
              for name, (a, w, _, _) in ops.items()}
    want_routes = {**{g[0]: "pipelined" for g in gemms + list(SQUARE)},
                   **{r[0]: "grid" for r in RAGGED}}
    check(routes == want_routes, f"routes {routes}, expected {want_routes}")
    for counts in (dcim_matmul_int.launches, dcim_matmul.launches):
        for route in counts:
            counts[route] = 0
    outs = {}
    for name, (a, w, asc, wsc) in ops.items():
        outs[name] = (dcim_matmul_int(a, w),
                      dcim_matmul(a, w, asc, wsc, out_dtype=torch.float32),
                      dcim_matmul(a, w, asc, wsc, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    by_route = {"dcim_mac_int": dict(dcim_matmul_int.launches),
                "dcim_mac": dict(dcim_matmul.launches)}
    log(f"mac: launches on the main path, per route {by_route}")
    per_route = {r: sum(v == r for v in routes.values())
                 for r in ("pipelined", "grid")}
    check(by_route["dcim_mac_int"] == per_route
          and by_route["dcim_mac"] == {r: 2 * c for r, c in per_route.items()},
          f"launch counts {by_route} for routes {per_route}")
    launches = {k: sum(v.values()) for k, v in by_route.items()}

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
        "(int32, f32, bf16; qwen3-4b, ragged and square shapes; both "
        "routes)")

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
    a, w = ops["wk"][0], ops["wk"][1]
    return kernels, (a, w, outs["wk"][0])


# ---------------------------------------------------------------------------
# 4. csa
# ---------------------------------------------------------------------------


def _csa_bound_ms(h: int, n: int, bh: int | None = None
                  ) -> tuple[float, str]:
    """Least time of an (H, N) column reduction on the card: the stack read
    once and the sums written once, against the schedule's word operations
    (8 per full adder, 1 per add) over the INT32 rate; ``bh`` is the tile
    height of the tiled kernel (its program runs once per H tile)."""
    from repro_torch.kernels.csa_tree import build_schedule
    from repro_torch.kernels.csa_tree.ref import FA

    rows = bh or h
    ops = build_schedule(rows).ops
    per_tile = 8 * int((ops[:, 0] == FA).sum()) + int((ops[:, 0] != FA).sum())
    tiles = -(-h // rows)
    t_bytes = 4 * (h * n + n) / HBM_BYTES_PER_S
    t_ops = (per_tile + (tiles - 1)) * n / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_csa(wk) -> list[dict]:
    """The adder tree of the macro the compiler designs, on the qwen3-4b wk
    GEMM executed on the scenario specs' 64-row macro: every 64-row K chunk
    of the (K, M*N) product stack through ``csa_tree_sum`` (rows route),
    every 256-row K chunk (a 256-row macro's, the tall rows route), the
    whole-K stack through the tiled route, plus ragged and wrapping stacks;
    each output held equal to the plain version, and the three reductions
    to the ``dcim_mac`` product."""
    import torch

    from repro_torch.core import scenario_specs
    from repro_torch.kernels.csa_tree import (CSA_MAX_ROWS, CSA_REG_ROWS,
                                              csa_tree_ref, csa_tree_sum)
    from repro_torch.kernels.csa_tree.kernel import rows_kernel
    from repro_torch.kernels.tiles import DEFAULT_TILES

    a, w, product = wk
    heights = {s.h for s in scenario_specs().values()}
    check(heights == {CSA_MACRO_ROWS},
          f"scenario macros have {heights} rows, expected {CSA_MACRO_ROWS}")
    (m, k), n = a.shape, w.shape[1]
    # stack[k, m * N + n] = a[m, k] * w[k, n]: the products one macro column
    # of K rows reduces; a macro's K chunks are row slices of it
    stack = (a.t().to(torch.int32)[:, :, None]
             * w.to(torch.int32)[:, None, :]).reshape(k, m * n).contiguous()
    chunks = {h: [stack[c:c + h] for c in range(0, k, h)]
              for h in (CSA_MACRO_ROWS, CSA_TALL_MACRO_ROWS)}
    check(k % CSA_TALL_MACRO_ROWS == 0
          and CSA_REG_ROWS < CSA_TALL_MACRO_ROWS <= CSA_MAX_ROWS,
          "the 256-row K chunks must be whole stacks of the tall rows route")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    extremes = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, 0, 1],
                            dtype=torch.int32, device="cuda")
    check(max(h for h, _ in CSA_RAGGED) > CSA_MAX_ROWS
          and any(CSA_REG_ROWS < h <= CSA_MAX_ROWS for h, _ in CSA_RAGGED),
          "the ragged stacks must reach the tiled route and the tall rows")
    ragged = {}
    for shape in CSA_RAGGED[:-1]:
        ragged["x".join(map(str, shape))] = torch.randint(
            -2 ** 16, 2 ** 16, shape, generator=g, device="cuda",
            dtype=torch.int32)
    shape = CSA_RAGGED[-1]
    ragged["extremes_" + "x".join(map(str, shape))] = extremes[
        torch.randint(0, 5, shape, generator=g, device="cuda")]

    def launch_key(h: int) -> str:
        return "tiled" if h > CSA_MAX_ROWS else rows_kernel(h)

    # -- the main path -------------------------------------------------------
    for key in csa_tree_sum.launches:
        csa_tree_sum.launches[key] = 0
    outs = {h: [csa_tree_sum(x) for x in xs] for h, xs in chunks.items()}
    whole = csa_tree_sum(stack)
    ragged_outs = {(name, comp): csa_tree_sum(x, use_compressors=comp)
                   for name, x in ragged.items() for comp in (True, False)}
    torch.cuda.synchronize()
    launches = dict(csa_tree_sum.launches)
    log(f"csa: launches on the main path {launches}")
    expected = {"rows": 0, "tiled": 1, "rows_tall": 0}
    for h, xs in chunks.items():
        expected[launch_key(h)] += len(xs)
    for x in ragged.values():
        expected[launch_key(x.shape[0])] += 2
    check(launches == expected,
          f"csa launch counts {launches}, expected {expected}")

    # -- held against the plain version and the MAC product -----------------
    err = 0.0
    for h, xs in chunks.items():
        for x, got in zip(xs, outs[h]):
            check(torch.equal(got, csa_tree_ref(x)),
                  f"csa: a {h}-row K-chunk reduction differs from its plain "
                  f"version")
        total = torch.stack(outs[h]).sum(0, dtype=torch.int32).reshape(m, n)
        check(torch.equal(total, product),
              f"csa: the {len(xs)} {h}-row K-chunk sums differ from "
              f"dcim_matmul_int(a, w)")
    check(torch.equal(whole, csa_tree_ref(stack))
          and torch.equal(whole.reshape(m, n), product),
          "csa: the whole-K tiled reduction differs")
    for (name, comp), got in ragged_outs.items():
        want = csa_tree_ref(ragged[name])
        err = max(err, (got.double() - want.double()).abs().max().item())
        check(torch.equal(got, want),
              f"csa: {name} (compressors={comp}) differs from its plain "
              f"version")
    log(f"csa: {len(chunks[CSA_MACRO_ROWS])} chunks of {CSA_MACRO_ROWS}x"
        f"{m * n} (rows route), {len(chunks[CSA_TALL_MACRO_ROWS])} chunks of "
        f"{CSA_TALL_MACRO_ROWS}x{m * n} (tall rows route) and the {k}x"
        f"{m * n} stack (tiled route) equal the plain version and sum to "
        f"dcim_matmul_int(a, w) bit for bit; ragged and wrapping stacks "
        f"equal, both compressor settings")

    # -- times ----------------------------------------------------------------
    def timed(label, xs, bound, reps=20):
        """Kernel, plain and torch.sum times of csa_tree_sum over the
        stacks ``xs`` (one call each), beside the bound."""
        row = dict(
            label=label, bound=bound,
            ms=_time_ms(lambda: [csa_tree_sum(x) for x in xs], reps),
            plain_ms=_time_ms(lambda: [csa_tree_ref(x) for x in xs], reps),
            library_ms=_time_ms(lambda: [torch.sum(x, 0, dtype=torch.int32)
                                         for x in xs], reps))
        log(f"csa: csa_tree_{label}: kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, torch.sum {row['library_ms']:.6f} "
            f"ms, bound {bound[0]:.6f} ms ({bound[1]})")
        return row

    def bound_of(h, n, count=1, bh=None):
        ms, by = _csa_bound_ms(h, n, bh)
        return ms * count, by

    tall_small = ragged["300x1000"]
    rows = {
        "rows": timed(f"rows ({len(chunks[CSA_MACRO_ROWS])} chunks of "
                      f"{CSA_MACRO_ROWS}x{m * n})", chunks[CSA_MACRO_ROWS],
                      bound_of(CSA_MACRO_ROWS, m * n,
                               len(chunks[CSA_MACRO_ROWS]))),
        "tiled": timed(f"tiled ({k}x{m * n})", [stack],
                       bound_of(k, m * n, 1, DEFAULT_TILES["csa_tree"].bh),
                       reps=10),
        "rows_tall": timed(
            f"rows_tall ({len(chunks[CSA_TALL_MACRO_ROWS])} chunks of "
            f"{CSA_TALL_MACRO_ROWS}x{m * n})", chunks[CSA_TALL_MACRO_ROWS],
            bound_of(CSA_TALL_MACRO_ROWS, m * n,
                     len(chunks[CSA_TALL_MACRO_ROWS]))),
        "rows_tall_small": timed("rows_tall (300x1000)", [tall_small],
                                 bound_of(*tall_small.shape)),
    }
    # the tall rows route's entry sums its two timed shapes
    tall = {key: rows["rows_tall"][key] + rows["rows_tall_small"][key]
            for key in ("ms", "plain_ms", "library_ms")}
    tall["bound"] = (rows["rows_tall"]["bound"][0]
                     + rows["rows_tall_small"]["bound"][0],
                     rows["rows_tall"]["bound"][1])
    src = "src/repro_torch/csrc/csa_tree_reg.cu.in"
    tpu = "src/repro/kernels/csa_tree/kernel.py"
    out = []
    for name, key, row, line in (
            ("csa_tree_rows", "rows", rows["rows"], 95),
            ("csa_tree_tiled", "tiled", rows["tiled"], 158),
            ("csa_tree_rows_tall", "rows_tall", tall, 95)):
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{tpu}:{line}", "launches": launches[key],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"]})
    return out


# ---------------------------------------------------------------------------
# 5. ssm
# ---------------------------------------------------------------------------


def _ssm_bound_ms(t: int, d: int) -> tuple[float, str]:
    """a and b read once, h0 read once, states and final written once,
    against one multiply and one add per element at the float32 rate."""
    t_bytes = 4 * (3 * t * d + 2 * d) / HBM_BYTES_PER_S
    t_ops = 2 * t * d / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_ssm() -> list[dict]:
    """One zamba2-1.2b Mamba2 layer's SSD state, flattened (64 heads x
    state 64 x head_dim 64 = 262,144 columns, batch 1), scanned over 1024
    steps, plus the tuned shape classes and a ragged shape: every depth
    equal bit for bit to the chunked plain version with the shape's chunk
    split, and within the JAX package's tolerance of the sequential plain
    version."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import TileConfig
    from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,
                                              ssm_scan_chunked_ref,
                                              ssm_scan_ref)

    cfg = get_config("zamba2-1.2b")
    heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    width = heads * cfg.ssm.state * cfg.ssm.head_dim
    check(width == 262_144, f"zamba2 SSD state width {width}")
    shapes = [(1024, width), (1024, 256), (4096, 256), (1000, 300)]
    check(ssm_chunks(1024, width)[0] == 1
          and all(ssm_chunks(*shape)[0] > 1 for shape in shapes[1:]),
          "the zamba2 state must run one pass and the narrow states chunks")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = {}
    for t, d in shapes:
        # a in [0.8, 1.0), b normal, as the JAX package's benchmark draws
        # them; h0 normal, so the carry-in is exercised
        inputs[(t, d)] = (
            0.8 + 0.2 * torch.rand((t, d), generator=g, device="cuda"),
            torch.randn((t, d), generator=g, device="cuda"),
            torch.randn((d,), generator=g, device="cuda"))
    tiles = {depth: TileConfig(depth=depth) for depth in (1, 2, 3, 4)}

    # -- the main path -------------------------------------------------------
    for key in ssm_scan.launches:
        ssm_scan.launches[key] = 0
    outs = {}
    for shape, (a, b, h0) in inputs.items():
        outs[shape] = {1: ssm_scan(a, b, h0, tile_config=tiles[1]),
                       2: ssm_scan(a, b, h0),
                       4: ssm_scan(a, b, h0, tile_config=tiles[4])}
    torch.cuda.synchronize()
    launches = dict(ssm_scan.launches)
    log(f"ssm: launches on the main path {launches}")
    # a chunked call launches the summary kernel, then the states kernel
    kernels = sum(2 if ssm_chunks(*shape)[0] > 1 else 1 for shape in shapes)
    check(launches == {"grid": kernels, "pipelined": 2 * kernels},
          f"ssm launch counts {launches}, expected {kernels} kernels per "
          f"depth")

    # -- held against the chunked and the sequential plain versions ---------
    err = 0.0
    for (t, d), (a, b, h0) in inputs.items():
        outs[(t, d)][3] = ssm_scan(a, b, h0, tile_config=tiles[3])
        chunks, rows = ssm_chunks(t, d)
        want_cs, want_cf = ssm_scan_chunked_ref(a, b, h0, chunks)
        want_s, want_f = ssm_scan_ref(a, b, h0)
        tol = 2e-5 if t % 32 == 0 and d % 32 == 0 else 3e-5
        for depth, (s, f) in sorted(outs[(t, d)].items()):
            check(s.shape == (t, d) and f.shape == (d,)
                  and bool(torch.isfinite(s).all()),
                  f"ssm {t}x{d} depth {depth}: bad output")
            check(torch.equal(s, want_cs) and torch.equal(f, want_cf),
                  f"ssm {t}x{d} depth {depth}: differs from the chunked "
                  f"plain version ({chunks} chunks of {rows} rows)")
            for got, want in ((s, want_s), (f, want_f)):
                diff = (got - want).abs()
                err = max(err, diff.max().item())
                check(bool((diff <= tol + tol * want.abs()).all()),
                      f"ssm {t}x{d} depth {depth}: outside rtol/atol {tol} "
                      f"of the sequential plain version (max |diff| "
                      f"{diff.max().item()})")
        s1, f1 = outs[(t, d)][1]
        log(f"ssm: {t}x{d}: S = {chunks} chunks of L = {rows} rows; depths "
            f"1-4 equal the chunked plain version bit for bit; max |diff| "
            f"to the sequential plain version "
            f"{(s1 - want_s).abs().max().item():.3e} (states), "
            f"{(f1 - want_f).abs().max().item():.3e} (final), tolerance "
            f"rtol/atol {tol}")

    # -- times ----------------------------------------------------------------
    rows = []
    for (t, d), (a, b, h0) in inputs.items():
        chunks = ssm_chunks(t, d)[0]
        row = dict(shape=(t, d), bound=_ssm_bound_ms(t, d), plain=_time_ms(
            lambda: ssm_scan_chunked_ref(a, b, h0, chunks), reps=3))
        for depth, tc in tiles.items():
            row[depth] = _time_ms(lambda: ssm_scan(a, b, h0, tile_config=tc))
        rows.append(row)
        log(f"ssm: {t}x{d} (S = {chunks}): depth 1 {row[1]:.6f} ms, depth 2 "
            f"{row[2]:.6f} ms, depth 3 {row[3]:.6f} ms, depth 4 "
            f"{row[4]:.6f} ms, plain {row['plain']:.6f} ms, bound "
            f"{row['bound'][0]:.6f} ms ({row['bound'][1]})")
    bound = sum(r["bound"][0] for r in rows)
    by = "bytes" if all(r["bound"][1] == "bytes" for r in rows) \
        else "operations"
    src = "src/repro_torch/csrc/ssm_scan.cu"
    tpu = "src/repro/kernels/ssm_scan/kernel.py"
    plain = sum(r["plain"] for r in rows)
    # no single torch call computes the recurrence: cumprod/cumsum forms
    # divide by running products and compute something else numerically
    return [
        {"name": "ssm_scan_grid", "route": "cuda", "source": src,
         "replaces": f"{tpu}:74", "launches": launches["grid"],
         "max_abs_err": err, "ms": sum(r[1] for r in rows),
         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
         "library_ms": None},
        {"name": "ssm_scan_pipelined", "route": "cuda", "source": src,
         "replaces": f"{tpu}:183", "launches": launches["pipelined"],
         "max_abs_err": err, "ms": sum(r[2] for r in rows),
         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
         "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# 6. autotune
# ---------------------------------------------------------------------------

# the warm-cache script's default tuning targets
TUNE_TARGETS = (("dcim_mac", (128, 512, 512)), ("dcim_mac", (512, 512, 512)),
                ("ssm_scan", (1024, 256)), ("ssm_scan", (4096, 256)),
                ("csa_tree", (256, 512)), ("csa_tree", (1024, 512)))


def phase_autotune() -> None:
    """The tile autotuner on the card for every default target (each winner
    within its exactness gate), then one ``tile_config="auto"`` call of each
    entry point, which must read the tuner's memo."""
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels.csa_tree import csa_tree_sum
    from repro_torch.kernels.dcim_mac import dcim_matmul_int
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.obs.metrics import get_registry

    autotune.clear_memo()
    for kernel, shape in TUNE_TARGETS:
        t0 = time.perf_counter()
        res = autotune.autotune(kernel, shape)
        (won,) = [c for c in res.candidates if c.config == res.winner]
        check(won.ok and won.max_err <= autotune._MAX_ERR[kernel],
              f"autotune {kernel} {shape}: winner fails its exactness gate")
        n_ok = sum(c.ok for c in res.candidates)
        log(f"autotune: {kernel} {'x'.join(map(str, shape))}: winner "
            f"{res.winner.as_dict()} {res.time_us:.3f} us (max |diff| "
            f"{won.max_err}), {n_ok}/{len(res.candidates)} candidates pass, "
            f"frontier {len(res.frontier)}, default "
            f"{'kept' if not res.picked_nondefault else 'beaten'}; "
            f"{time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    calls = {
        "dcim_mac": lambda: dcim_matmul_int(
            torch.randint(-8, 8, (128, 512), generator=g, device="cuda",
                          dtype=torch.int8),
            torch.randint(-8, 8, (512, 512), generator=g, device="cuda",
                          dtype=torch.int8), tile_config="auto"),
        "ssm_scan": lambda: ssm_scan(
            torch.rand((1024, 256), generator=g, device="cuda"),
            torch.randn((1024, 256), generator=g, device="cuda"),
            torch.zeros(256, device="cuda"), tile_config="auto"),
        "csa_tree": lambda: csa_tree_sum(
            torch.randint(-99, 99, (256, 512), generator=g, device="cuda",
                          dtype=torch.int32), tile_config="auto"),
    }
    reg = get_registry()
    for kernel, call in calls.items():
        counter = reg.counter(f"kernel/{kernel}/tile_source/memo")
        before = counter.value
        call()
        check(counter.value == before + 1,
              f"autotune: {kernel} tile_config=\"auto\" did not read the "
              f"memo")
    torch.cuda.synchronize()
    log("autotune: tile_config=\"auto\" of dcim_matmul_int, ssm_scan and "
        "csa_tree_sum each read the tuner's memo (kernel/<k>/tile_source/"
        "memo +1)")


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
    kernels, wk = phase_mac(chosen["language"])
    t3 = time.perf_counter()
    kernels += phase_csa(wk)
    t4 = time.perf_counter()
    kernels += phase_ssm()
    t5 = time.perf_counter()
    phase_autotune()
    t6 = time.perf_counter()
    log(f"phases: device {t1 - t0:.3f} s, compiler {t2 - t1:.3f} s, "
        f"mac {t3 - t2:.3f} s, csa {t4 - t3:.3f} s, ssm {t5 - t4:.3f} s, "
        f"autotune {t6 - t5:.3f} s")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its main path: "
          f"{[k['name'] for k in kernels if not k['launches']]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
