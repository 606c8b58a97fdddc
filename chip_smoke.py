#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. device    print the card's name and power limit, build every CUDA
               kernel of the port from ``src/repro_torch/csrc``: the
               hand-written sources, their profiling skeletons (the
               ``skeletons`` build of ``dcim_mac.cu`` and ``ssm_scan.cu``)
               and the ``csa_tree`` register kernels generated for the row
               counts this run uses (one first, alone, for its first-use
               build time), all in parallel; print each kernel's registers
               and spill bytes from its ptxas report (a spill in a
               ``csa_tree`` or ``dcim_mac`` kernel fails the run, as do a
               ``dcim_mac`` TMA kernel whose wgmma pipeline ptxas
               serialized or, where it has ``setmaxnreg``, whose registers
               are not the 168 its budget assumes);
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
               (``pipelined``), the ragged shapes whose rows TMA cannot
               describe on the ``grid`` route;
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
  7. profile   the kernels' profiling skeletons (``dcim_mac`` copy and
               compute at int32, float32 and bfloat16, ``csa_tree`` copy,
               ``ssm_scan`` copy and compute)
               first held bit for bit against their plain versions at the
               main-path shapes (the six qwen3-4b GEMMs, the wk product
               stack on the tiled route, the zamba2 state and (4096, 256))
               and one ragged shape each; then ``profile_kernel`` on the
               main-path shapes, one line per point (copy / compute / fused
               us, bound, fraction), and its artifact written to
               ``chiprun_out/kernel_profile.json``;
  8. serving   the compiler phase's four scenario searches on cuda and on
               cpu pooled by ``frontier_union``, then
               ``cross_workload_codesign`` over the qwen3-4b and
               zamba2-1.2b GEMM inventories (full width, every layer): the
               two reports bit-identical; ``dcim_serving_bound`` of each
               workload's best macro at ``kernel_fraction`` 1.0 and at the
               fraction the profile phase measured;
  9. service   the compiler's serving path on the card
               (``repro_torch.service``, ``serve.select``, the layout
               tail): a ``SynthesisService`` on the card with a disk store
               behind a ``ServiceFrontend`` takes the four scenario specs
               as INTERACTIVE requests, the same four again and one BULK
               sweep: one fused engine pass, four coalesced duplicates,
               every frontier equal to the compiler phase's cuda search bit
               for bit; a second service on the same store answers the four
               from disk with no engine pass; ``scripts/torch_warm_cache.py
               --autotune-kernels default`` fills a registry in a
               subprocess, and ``tile_config="auto"`` of ``dcim_matmul``,
               ``csa_tree_sum`` and ``ssm_scan`` then resolves from it
               (``tile_source/registry``) and equals the plain versions;
               ``select_macros`` for qwen3-4b and zamba2-1.2b through the
               frontend at the profiled fraction picks what the serving
               phase's co-design picks, with the same tokens/s bit for bit;
               the qwen3-4b macro's RTL, DEF and SDP script equal those of
               the CPU run's pick, its adder tree passes the gate-level
               check, and ``csa_tree_sum`` on the card equals
               ``gatesim.simulate`` of its netlist at its 64 rows and at
               256; ``examples/torch_quickstart.py`` prints ``PASS``;
 10. model     the port's model zoo serving qwen3-4b (36 layers, 4.41e9
               parameters), then, each one's weights freed before the
               next, granite-moe-3b-a800m, rwkv6-7b and zamba2-1.2b, each
               at its full config (bf16) through one routine: the weights
               drawn on the card from a generator seeded 0 (layer and
               parameter counts checked and printed); prefill of 4 x 64
               tokens and greedy decode steps (32 for qwen3-4b, 8 for the
               rest; init s, prefill ms, decode ms per step, tokens/s, peak
               memory and the step's bound printed; logits finite over the
               vocabulary, the padding masked, of the right shapes); for
               rwkv6 and zamba2 whether a 4 x 256-token prefill in the
               config is finite (printed, not gated: the reference's
               chunked scan can leave float32 there); for all but MoE, one
               decode step after a 64-token prefill against the 65-token
               prefill at full width in float32 without fake-quant (within
               F32_TOL_FRAC, the argmax kept wherever the top two are not
               tied within twice the difference); the config at 2 layers
               in float32 without fake-quant on the card against the CPU
               (within F32_TOL_FRAC and 8 greedy tokens equal, unless an
               MoE expert choice flipped, which must then be a near-tie of
               the CPU's gates within EXPERT_TIE and is printed); and
               ``python -m repro_torch.launch.serve --arch <model>
               --dcim-select`` at the full config as a subprocess on one
               frontier store, its selection and tokens/s bound equal to
               ``select_macros``' and its times naming the card.  qwen3-4b
               adds: the cache check in the config (prefill of 63 tokens
               plus one decode step against the prefill of 64, within
               BF16_TOL_FRAC); the card against the CPU with fake-quant on
               (every weight's fake-quant equal, the first differing
               activation quantizer call off by single code steps); and a
               cold launch with the profile phase's artifact before the
               warm one (one fused pass cold, none warm, the service
               phase's pick).  It launches no hand-written kernel: the
               models' products are ``torch.matmul`` and ``torch.einsum``
               of fake-quantised operands, as the JAX models' are
               ``jnp.matmul`` and ``jnp.einsum``;
 11. report    one ``{"kernels": [...]}`` line, then as the last line
               ``{"ok": true, "device": {...}}``.

Each of phases 3-5 and 7 sets its kernels' launch counts to 0 just before
its main path and reads them just after (phase 7 twice: K1 through
``profile_kernel``, then K2, the float32 / bfloat16 ``dcim_mac`` skeletons,
timed at the six qwen3-4b GEMMs); every kernel must have launched.

It needs one CUDA card and exits non-zero without one, and when it does not
sit at the root of a checkout of the repository.
"""

from __future__ import annotations

import contextlib
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

# Ragged shapes of the JAX package's kernel tests (the grid route for rows
# TMA cannot describe, GRID_ROUTE; one token on the TMA route) and an
# aligned square M == N shape on the TMA route (a row scale read as a
# column scale would show), checked for equality only; times and bounds
# are reported over the qwen3-4b GEMMs.
RAGGED = (("ragged_8x16x8", 8, 16, 8), ("ragged_130x96x200", 130, 96, 200),
          ("ragged_1x512x64", 1, 512, 64))
GRID_ROUTE = {"ragged_8x16x8", "ragged_130x96x200"}
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
    from repro_torch.kernels.build import (CSRC, SKELETON_SOURCES,
                                          SKELETONS, build_library,
                                          ptxas_report, wgmma_serialized)
    from repro_torch.kernels.csa_tree.kernel import register_library
    from repro_torch.kernels.dcim_mac.kernel import tma_kernel_mode

    t0 = time.perf_counter()
    first = register_library(CSA_MACRO_ROWS, True)
    log(f"device: first-use build of the generated {CSA_MACRO_ROWS}-row "
        f"csa_tree register kernel alone: {time.perf_counter() - t0:.3f} s")
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    generated = sorted(csa_register_kernels() - {(CSA_MACRO_ROWS, True)})
    jobs = [lambda n=n: build_library(n) for n in names]
    jobs += [lambda n=n: build_library(n, SKELETONS)
             for n in SKELETON_SOURCES]
    jobs += [lambda r=r: register_library(*r) for r in generated]

    def timed(job):
        t = time.perf_counter()
        return job(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(timed, jobs))
    log(f"device: built {names}, the {SKELETONS} of {list(SKELETON_SOURCES)} "
        f"and {len(generated)} more generated "
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
            if tma_kernel_mode(fn) in ("fused", "compute"):
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
    return {"language": res_g[names.index("language")],
            "results": {"cuda": res_g, "cpu": res_c}}


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
    """Median device time of one ``fn()`` call: CUDA events, the L2 cache
    flushed and the device spun before each call
    (:func:`repro_torch.kernels.timing.times_ms`)."""
    import torch

    from repro_torch.kernels.timing import times_ms
    return float(np.median(times_ms(fn, reps, torch.device("cuda"))))


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
    want_routes = {name: "grid" if name in GRID_ROUTE else "pipelined"
                   for name in ops}
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


def _product_stack(a, w):
    """stack[k, m * N + n] = a[m, k] * w[k, n] (int32): the products one
    macro column of K rows reduces; a macro's K chunks are row slices of
    it."""
    import torch
    (m, k), n = a.shape, w.shape[1]
    return (a.t().to(torch.int32)[:, :, None]
            * w.to(torch.int32)[:, None, :]).reshape(k, m * n).contiguous()


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
    stack = _product_stack(a, w)
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


# ---------------------------------------------------------------------------
# 7. profile
# ---------------------------------------------------------------------------

# One ragged shape per kernel beside the main-path shapes for the
# skeletons' check: ragged M and N over a K whose last stage is partial; a
# ragged last tile; T not a multiple of bt (the copy skeleton's final state
# is then its last state, not h0).
PROFILE_RAGGED = {"dcim_mac": (130, 2000, 208), "csa_tree": (600, 300),
                  "ssm_scan": (1000, 300)}

# The zamba2-1.2b Mamba2 layer's SSD state (phase ssm)
ZAMBA_STATE = (1024, 262_144)

# The skeletons: kernels-line name -> (kernel, mode, TPU site of its body)
SKELETON_KERNELS = {
    "dcim_mac_tma_copy": ("dcim_mac", "copy",
                          "src/repro/kernels/dcim_mac/kernel.py:159"),
    "dcim_mac_tma_compute": ("dcim_mac", "compute",
                             "src/repro/kernels/dcim_mac/kernel.py:159"),
    "csa_tree_tiled_copy": ("csa_tree", "copy",
                            "src/repro/kernels/csa_tree/kernel.py:128"),
    "ssm_scan_copy": ("ssm_scan", "copy",
                      "src/repro/kernels/ssm_scan/kernel.py:120"),
    "ssm_scan_compute": ("ssm_scan", "compute",
                         "src/repro/kernels/ssm_scan/kernel.py:120"),
}


# K2, the float32 / bfloat16 skeletons of dcim_matmul_pipelined_pallas:
# kernels-line name -> (mode, output dtype)
SCALED_SKELETONS = {
    "dcim_mac_tma_copy_f32": ("copy", "float32"),
    "dcim_mac_tma_compute_f32": ("compute", "float32"),
    "dcim_mac_tma_copy_bf16": ("copy", "bfloat16"),
    "dcim_mac_tma_compute_bf16": ("compute", "bfloat16"),
}
SCALED_SITE = "src/repro/kernels/dcim_mac/kernel.py:239"


def _skeleton_bound_ms(name: str, shape, out_bytes: int = 4,
                       epilogue: bool = False) -> tuple[float, str]:
    """Least time of one skeleton call's work on the card, at the default
    tile: the bytes its token needs moved (inputs read once, outputs
    written once) against the operations it needs, each at its peak.  A
    ``dcim_mac`` skeleton with the dequant ``epilogue`` also reads the
    scales and makes two float32 products per output of ``out_bytes``."""
    from repro_torch.kernels.dcim_mac import mac_plan
    from repro_torch.kernels.ssm_scan import ssm_chunks
    from repro_torch.kernels.tiles import DEFAULT_TILES

    if name.startswith("dcim_mac"):
        m, k, n = shape
        plan = mac_plan(m, k, n)
        if name.endswith("copy"):
            # A and W streamed, the token summed per strip, the output
            nbytes = m * k + k * n + out_bytes * m * n
            t_ops = (2 * plan.stages * plan.m_strips * plan.n_strips
                     / INT32_OPS_PER_S)
        else:
            # each split's first stage read, all its stages' products
            widths = [min(128, k - k0) for k0, _ in plan.k_ranges]
            nbytes = sum((m + n) * wd for wd in widths) + out_bytes * m * n
            t_ops = sum(2 * m * n * wd * (e - b) for wd, (b, e) in
                        zip(widths, plan.stage_ranges)) / INT8_OPS_PER_S
        if epilogue:
            nbytes += 4 * (m + n)
            t_ops += 2 * m * n / F32_OPS_PER_S
    elif name.startswith("csa_tree"):
        h, n = shape
        bh = DEFAULT_TILES["csa_tree"].bh
        nbytes = 4 * (h * n + n)
        t_ops = -(-h // bh) * n / INT32_OPS_PER_S
    else:
        t, d = shape
        chunks, rows = ssm_chunks(t, d)
        if name.endswith("copy"):
            nbytes = 4 * (3 * t * d + 2 * d)
            t_ops = t * d / F32_OPS_PER_S
        else:
            # each chunk's resident rows, h0 and the final state; passes 1
            # and 2 for the chunks before the last, pass 3 for the last
            sub = min(DEFAULT_TILES["ssm_scan"].bt, rows)
            last = t - (chunks - 1) * rows
            nbytes = 4 * (2 * chunks * sub * d + 2 * d)
            t_ops = ((3 * (chunks - 1) * rows + 2 * (chunks - 1) + 2 * last)
                     * d / F32_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_profile(wk) -> tuple[list[dict], Path]:
    """The profiling skeletons held bit for bit against their plain
    versions at the main-path shapes and a ragged one each, then
    ``profile_kernel`` on the main-path shapes; returns the skeletons'
    entries of the kernels line and the artifact's path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import gemm_inventory
    from repro_torch.kernels import profile
    from repro_torch.kernels.csa_tree import kernel as csa_k
    from repro_torch.kernels.csa_tree.ref import csa_tree_copy_ref
    from repro_torch.kernels.dcim_mac import kernel as mac_k
    from repro_torch.kernels.dcim_mac import ref as mac_ref
    from repro_torch.kernels.ssm_scan import kernel as ssm_k
    from repro_torch.kernels.ssm_scan import ssm_chunks
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_compute_ref,
                                                  ssm_scan_copy_ref)
    from repro_torch.kernels.tiles import DEFAULT_TILES

    mac_tc, csa_tc, ssm_tc = (DEFAULT_TILES[k] for k in
                              ("dcim_mac", "csa_tree", "ssm_scan"))
    a_wk, w_wk, _ = wk
    stack = _product_stack(a_wk, w_wk)
    points = {
        "dcim_mac": [(g.m, g.k, g.n) for g in
                     gemm_inventory(get_config("qwen3-4b"), seq=256)],
        "csa_tree": [tuple(stack.shape)],
        "ssm_scan": [ZAMBA_STATE, (4096, 256)],
    }
    g = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = {"csa_tree": {tuple(stack.shape): (stack,)}}
    for m, k, n in points["dcim_mac"] + [PROFILE_RAGGED["dcim_mac"]]:
        inputs.setdefault("dcim_mac", {})[(m, k, n)] = tuple(
            torch.randint(-128, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8) for shape in ((m, k), (k, n)))
    inputs["csa_tree"][PROFILE_RAGGED["csa_tree"]] = (torch.randint(
        -2 ** 31, 2 ** 31 - 1, PROFILE_RAGGED["csa_tree"], generator=g,
        device="cuda", dtype=torch.int32),)
    for t, d in points["ssm_scan"] + [PROFILE_RAGGED["ssm_scan"]]:
        inputs.setdefault("ssm_scan", {})[(t, d)] = (
            0.8 + 0.2 * torch.rand((t, d), generator=g, device="cuda"),
            torch.randn((t, d), generator=g, device="cuda"),
            torch.randn((d,), generator=g, device="cuda"))

    def kernel_call(name, args):
        kernel, mode, _ = SKELETON_KERNELS[name]
        if kernel == "dcim_mac":
            return mac_k.dcim_mac_int_cuda(*args, depth=mac_tc.depth,
                                           _mode=mode)
        if kernel == "csa_tree":
            return csa_k.csa_tree_tiled_cuda(*args, bh=csa_tc.bh,
                                             bn=csa_tc.bn, _mode=mode)
        return ssm_k.ssm_scan_cuda(*args, bt=ssm_tc.bt, bd=ssm_tc.bd,
                                   depth=ssm_tc.depth, _mode=mode)

    def plain_call(name, args):
        kernel, mode, _ = SKELETON_KERNELS[name]
        if kernel == "dcim_mac":
            return {"copy": mac_ref.dcim_mac_copy_ref,
                    "compute": mac_ref.dcim_mac_compute_ref}[mode](*args)
        if kernel == "csa_tree":
            return csa_tree_copy_ref(*args, csa_tc.bh)
        if mode == "copy":
            return ssm_scan_copy_ref(*args, ssm_tc.bt)
        chunks = ssm_chunks(*args[0].shape)[0]
        return ssm_scan_compute_ref(*args, chunks, ssm_tc.bt)

    # -- held: every skeleton's token equals its plain version --------------
    err = {name: 0.0 for name in SKELETON_KERNELS}
    for name, (kernel, mode, _) in SKELETON_KERNELS.items():
        for shape, args in inputs[kernel].items():
            got, want = kernel_call(name, args), plain_call(name, args)
            torch.cuda.synchronize()
            for x, y in (zip(got, want) if kernel == "ssm_scan"
                         else [(got, want)]):
                if y is None:
                    check(x is None, f"profile: {name} {shape}: states "
                          "written by the compute skeleton")
                    continue
                check(x.shape == y.shape and x.dtype == y.dtype,
                      f"profile: {name} {shape}: {x.shape}/{x.dtype} vs "
                      f"{y.shape}/{y.dtype}")
                diff = (x.double() - y.double()).abs().max().item()
                err[name] = max(err[name], diff)
                check(torch.equal(x, y),
                      f"profile: {name} {shape}: the skeleton differs from "
                      f"its plain version (max |diff| {diff})")
    log("profile: every skeleton equals its plain version bit for bit "
        "(dcim_mac copy and compute at the six qwen3-4b GEMMs and "
        f"{PROFILE_RAGGED['dcim_mac']}, csa_tree copy at the wk product "
        f"stack {tuple(stack.shape)} and {PROFILE_RAGGED['csa_tree']}, "
        f"ssm_scan copy and compute at {ZAMBA_STATE}, (4096, 256) and "
        f"{PROFILE_RAGGED['ssm_scan']})")

    # -- the main path: profile_kernel at the main-path shapes --------------
    for c in [*mac_k.SKELETON_LAUNCHES.values(), csa_k.SKELETON_LAUNCHES,
              ssm_k.SKELETON_LAUNCHES]:
        for key in c:
            c[key] = 0
    profiles = []
    for kernel, shapes in points.items():
        for shape in shapes:
            p = profile.profile_kernel(kernel, shape)
            profiles.append(p)
            log(f"profile: {kernel} {'x'.join(map(str, shape))}: copy "
                f"{p.t_copy_us:.3f} us, compute {p.t_compute_us:.3f} us"
                f"{'' if p.compute_measured else ' (fused - copy)'}, fused "
                f"{p.t_fused_us:.3f} us, {p.bound}-bound, roofline fraction "
                f"{p.roofline_fraction:.6f}")
    torch.cuda.synchronize()
    counts = {"dcim_mac": {mode: c["int32"] for mode, c in
                           mac_k.SKELETON_LAUNCHES.items()},
              "csa_tree": csa_k.SKELETON_LAUNCHES,
              "ssm_scan": ssm_k.SKELETON_LAUNCHES}
    launches = {name: counts[kernel][mode]
                for name, (kernel, mode, _) in SKELETON_KERNELS.items()}
    log(f"profile: skeleton launches on the main path {launches}")
    artifact = ROOT / "chiprun_out" / "kernel_profile.json"
    artifact.parent.mkdir(exist_ok=True)
    payload = profile.profiles_payload(profiles)
    artifact.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    log(f"profile: aggregate roofline fraction (geomean) "
        f"{payload['fraction']:.6f}; artifact {artifact.relative_to(ROOT)}")

    # -- the kernels line: times beside the plain version and the bound -----
    src = {"dcim_mac": "src/repro_torch/csrc/dcim_mac.cu",
           "csa_tree": "src/repro_torch/csrc/csa_tree_reg.cu.in",
           "ssm_scan": "src/repro_torch/csrc/ssm_scan.cu"}
    out = []
    for name, (kernel, mode, replaces) in SKELETON_KERNELS.items():
        ps = [p for p in profiles if p.kernel == kernel]
        bounds = [_skeleton_bound_ms(name, p.shape) for p in ps]
        bound = sum(b for b, _ in bounds)
        by_bytes = sum(b for b, by in bounds if by == "bytes")
        args = [inputs[kernel][p.shape] for p in ps]
        plain = sum(_time_ms(lambda a=a: plain_call(name, a), reps=3)
                    for a in args)
        # one torch call sums the tiles' first rows; no torch call computes
        # the other tokens
        library = (sum(_time_ms(lambda x=a[0]: torch.sum(
            x[::csa_tc.bh], 0, dtype=torch.int32), reps=3) for a in args)
            if kernel == "csa_tree" else None)
        out.append({
            "name": name, "route": "cuda", "source": src[kernel],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name],
            "ms": sum((p.t_copy_us if mode == "copy" else p.t_compute_us)
                      for p in ps) / 1e3,
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
            "library_ms": library})
        log(f"profile: {name}: {out[-1]['ms']:.6f} ms over "
            f"{[p.shape for p in ps]}, plain {plain:.6f} ms, bound "
            f"{bound:.6f} ms, library "
            f"{'none' if library is None else f'{library:.6f} ms'}")
    out += _profile_scaled(inputs["dcim_mac"], points["dcim_mac"],
                           mac_tc.depth, g)
    return out, artifact


def _profile_scaled(inputs: dict, shapes: list, depth: int, g) -> list[dict]:
    """K2: the float32 / bfloat16 copy and compute skeletons at the
    main-path GEMMs (and the ragged one), each output held bit for bit
    against its plain version; then, with their launch counts reset, each
    timed at the six GEMMs beside its plain version and bound.  Returns
    their entries of the kernels line."""
    import torch

    from repro_torch.kernels.dcim_mac import kernel as mac_k
    from repro_torch.kernels.dcim_mac import ref as mac_ref

    plain_of = {"copy": mac_ref.dcim_mac_copy_scaled_ref,
                "compute": mac_ref.dcim_mac_compute_scaled_ref}
    args = {}
    for (m, k, n), (a, w) in inputs.items():
        a_s = torch.rand(m, generator=g, device="cuda") + 0.01
        w_s = torch.rand(n, generator=g, device="cuda") + 0.01
        args[(m, k, n)] = (a, w, a_s, w_s)

    def kernel_call(name, a):
        mode, dtype = SCALED_SKELETONS[name]
        return mac_k.dcim_mac_cuda(*a, getattr(torch, dtype), depth=depth,
                                   _mode=mode)

    def plain_call(name, a):
        mode, dtype = SCALED_SKELETONS[name]
        return plain_of[mode](*a, getattr(torch, dtype))

    err = {}
    for name in SCALED_SKELETONS:
        err[name] = 0.0
        for shape, a in args.items():
            got, want = kernel_call(name, a), plain_call(name, a)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"profile: {name} {shape}: {got.shape}/{got.dtype} vs "
                  f"{want.shape}/{want.dtype}")
            diff = (got.double() - want.double()).abs().max().item()
            err[name] = max(err[name], diff)
            check(torch.equal(got, want),
                  f"profile: {name} {shape}: the skeleton differs from its "
                  f"plain version (max |diff| {diff})")
    log("profile: K2, the float32 and bfloat16 dcim_mac copy and compute "
        "skeletons, equal their plain versions (the int32 token through "
        "the dequant epilogue) bit for bit at the six qwen3-4b GEMMs and "
        f"{PROFILE_RAGGED['dcim_mac']}")

    # -- the main path: each skeleton at the six GEMMs, counts reset ---------
    for counts in mac_k.SKELETON_LAUNCHES.values():
        for key in counts:
            counts[key] = 0
    times = {name: [_time_ms(lambda n=name, a=args[s]: kernel_call(n, a))
                    for s in shapes] for name in SCALED_SKELETONS}
    torch.cuda.synchronize()
    launches = {name: mac_k.SKELETON_LAUNCHES[mode][dtype]
                for name, (mode, dtype) in SCALED_SKELETONS.items()}
    log(f"profile: K2 launches on its run {launches}")
    # K1 by the same timer, beside K2 (the kernels line keeps K1's times
    # from profile_kernel)
    for mode in ("copy", "compute"):
        int32 = [_time_ms(lambda a=args[s]: mac_k.dcim_mac_int_cuda(
            *a[:2], depth=depth, _mode=mode)) for s in shapes]
        log(f"profile: dcim_mac_tma_{mode} (int32) by the same timer: "
            f"{sum(int32):.6f} ms over the six GEMMs")
    out = []
    for name, (mode, dtype) in SCALED_SKELETONS.items():
        size = torch.empty((), dtype=getattr(torch, dtype)).element_size()
        bounds = [_skeleton_bound_ms(f"dcim_mac_{mode}", s, size, True)
                  for s in shapes]
        bound = sum(b for b, _ in bounds)
        by_bytes = sum(b for b, by in bounds if by == "bytes")
        plain = sum(_time_ms(lambda n=name, a=args[s]: plain_call(n, a),
                             reps=3) for s in shapes)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/dcim_mac.cu",
            "replaces": SCALED_SITE, "launches": launches[name],
            "max_abs_err": err[name], "ms": sum(times[name]),
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
            "library_ms": None})
        log(f"profile: {name}: {out[-1]['ms']:.6f} ms over {shapes} "
            f"(per GEMM {[round(x, 6) for x in times[name]]}), plain "
            f"{plain:.6f} ms, bound {bound:.6f} ms, library none")
    return out


# ---------------------------------------------------------------------------
# 8. serving
# ---------------------------------------------------------------------------


def phase_serving(results: dict, artifact: Path) -> dict:
    """Cross-workload co-design of the scenario frontiers' pool for the
    port's two configurations, from the cuda and the cpu searches (bit for
    bit the same), and the serving bound of each workload's best macro at
    kernel fractions 1.0 and as profiled.  Returns the workloads, both
    reports, the profiled fraction and the tokens/s at it."""
    from repro_torch.configs import get_config
    from repro_torch.core import (cross_workload_codesign, frontier_union,
                                  gemm_inventory)
    from repro_torch.kernels.profile import fraction_from_profile_artifact
    from repro_torch.roofline.dcim import dcim_serving_bound

    workloads = {arch: gemm_inventory(get_config(arch), seq=256)
                 for arch in ("qwen3-4b", "zamba2-1.2b")}
    reports = {dev: cross_workload_codesign(workloads,
                                            frontier_union(results[dev]))
               for dev in ("cuda", "cpu")}
    rg, rc = reports["cuda"], reports["cpu"]
    arrays = ("wallclock_s", "energy_pj", "effective_tops", "avg_util",
              "area_mm2", "total_wallclock_s", "total_energy_pj")
    check(rg.designs == rc.designs and rg.frontier == rc.frontier
          and all(_same_array(getattr(rg, f), getattr(rc, f))
                  for f in arrays)
          and all(rg.best_for(w) == rc.best_for(w) for w in workloads),
          "serving: the cuda and cpu co-design reports differ")
    check(len(rg.frontier) > 0, "serving: empty co-design frontier")
    log(f"serving: pool of {len(rg.designs)} designs from "
        f"{len(results['cuda'])} scenario frontiers; co-design frontier "
        f"{[rg.designs[i] for i in rg.frontier]}; cuda == cpu bit for bit "
        f"({', '.join(arrays)}, frontier, best_for)")
    fraction = fraction_from_profile_artifact(artifact)
    tokens_per_s = {}
    for wl, gemms in workloads.items():
        best = rg.best_for(wl)
        wall = float(rg.wallclock_s[rg.workloads.index(wl), best])
        for frac in (1.0, fraction):
            est = dcim_serving_bound(gemms, wall, workload=wl,
                                     macro=rg.designs[best],
                                     kernel_fraction=frac)
            check(np.isfinite(est.tokens_per_s) and est.tokens_per_s > 0,
                  f"serving: {wl}: no finite throughput")
            tokens_per_s[wl] = est.tokens_per_s
            log(f"serving: {wl} on {rg.designs[best]} at kernel_fraction "
                f"{frac!r}: t_macro {est.t_macro_s!r} s, t_hbm "
                f"{est.t_hbm_s!r} s, {est.tokens_per_s!r} tokens/s, "
                f"{est.bottleneck}")
    return {"workloads": workloads, "reports": reports, "fraction": fraction,
            "tokens_per_s": tokens_per_s}


# ---------------------------------------------------------------------------
# 9. service
# ---------------------------------------------------------------------------


def _same_result(a, b) -> bool:
    return (a.n_evaluated == b.n_evaluated
            and [_ppa_repr(p) for p in a.frontier]
            == [_ppa_repr(p) for p in b.frontier]
            and [_ppa_repr(p) for p in a.explored]
            == [_ppa_repr(p) for p in b.explored])


def phase_service(results: dict, serving: dict) -> str:
    """The serving path on the card, held against the compiler and serving
    phases' results (themselves held bit for bit against ``device="cpu"``):
    cold and warm launches of the service behind its frontend, the tile
    registry, macro selection and the layout tail (module doc, phase 9).
    Returns the qwen3-4b pick's label."""
    import shutil

    import torch

    import repro_torch.core as C
    from repro_torch.core import engine, gatesim, layout
    from repro_torch.core import subcircuits as sc
    from repro_torch.kernels import autotune
    from repro_torch.kernels.csa_tree import csa_tree_ref, csa_tree_sum
    from repro_torch.kernels.dcim_mac import dcim_matmul
    from repro_torch.kernels.dcim_mac.ref import dcim_matmul_ref
    from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,
                                              ssm_scan_chunked_ref)
    from repro_torch.obs.metrics import get_registry
    from repro_torch.serve import select_macros
    from repro_torch.service import (ArtifactRegistry, FrontierCache,
                                     Priority, ServiceFrontend,
                                     SynthesisRequest, SynthesisService)

    work = ROOT / "build" / "service"
    shutil.rmtree(work, ignore_errors=True)
    store, registry_root = work / "store", work / "registry"
    scen = C.scenario_specs()
    names, specs = list(scen), list(scen.values())
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
    want = results["cuda"]
    passes = []
    hook = lambda plan, elapsed: passes.append((len(plan), elapsed))
    engine.add_latency_hook(hook)
    try:
        # 1. cold launch: one fused pass for the four unique specs
        svc = SynthesisService(cache=FrontierCache(store_dir=store))
        check(svc.device.type == "cuda", f"service on {svc.device}")
        searches = [SynthesisRequest(spec=s, config=config, tag=n)
                    for n, s in zip(names, specs)]
        sweep = SynthesisRequest(spec=specs[0], kind="sweep",
                                 priority=Priority.BULK, tag="sweep")
        t0 = time.perf_counter()
        with ServiceFrontend(svc, window=0.05, max_batch=16) as front:
            tickets = [front.submit(r) for r in searches + searches + [sweep]]
            cold = [t.result(timeout=600) for t in tickets]
        wall = time.perf_counter() - t0
        st = svc.stats
        check(st.fused_passes == 1 and st.coalesced == 4 and st.misses == 5
              and front.stats.batches == 1,
              f"service: cold launch made {st.fused_passes} fused passes, "
              f"{st.coalesced} coalesced, {st.misses} misses in "
              f"{front.stats.batches} batches")
        for i, resp in enumerate(cold[:8]):
            check(resp.served_from == ("engine" if i < 4 else "coalesced")
                  and _same_result(resp.result, want[i % 4]),
                  f"service: {names[i % 4]} ({resp.served_from}) differs "
                  "from the compiler phase's cuda search")
        check(len(cold[8].result.frontier) > 0, "service: empty sweep")
        fused = [e for n, e in passes if n == 4]
        check(len(fused) == 1, f"service: fused passes seen {passes}")
        n_points = len(C.DesignLattice.enumerate(specs[0], config=config))
        log(f"service: cold launch on {svc.device}: 9 requests (4 scenario "
            f"searches at {n_points} points, 4 duplicates, 1 BULK sweep) "
            f"in {wall:.3f} s; one "
            f"fused pass of 4 specs {fused[0]:.6f} s (engine latency hook), "
            f"coalesced {st.coalesced}; frontiers == compiler phase cuda "
            "bit for bit")
        for r in cold:
            log(f"  {r.request.tag} ({r.served_from}): queued -> batched "
                f"{r.queue_delay_s:.6f} s, batched -> served "
                f"{r.served_at - r.batched_at:.6f} s")

        # 2. warm launch: a new service on the same store
        warm_svc = SynthesisService(cache=FrontierCache(store_dir=store))
        front = ServiceFrontend(warm_svc, window=0.005)
        t0 = time.perf_counter()
        warm = front.serve(searches, timeout=600)
        wall = time.perf_counter() - t0
        ws = warm_svc.stats
        check(ws.cache_hits == 4 and ws.misses == 0 and ws.fused_passes == 0
              and warm_svc.cache.stats.disk_hits == 4
              and all(_same_result(r.result, w)
                      for r, w in zip(warm, want)),
              f"service: warm launch {warm_svc.telemetry()}")
        log(f"service: warm launch: hits {ws.cache_hits} (disk "
            f"{warm_svc.cache.stats.disk_hits}), misses {ws.misses}, fused "
            f"passes {ws.fused_passes}, served in {wall:.6f} s; equal "
            "results")

        # 3. tile warm-up in a subprocess, then registry-resolved tiles
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_warm_cache.py"),
             "--store", str(work / "warm_store"), "--registry",
             str(registry_root), "--resolutions", "3", "--autotune-kernels",
             "default"], capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"torch_warm_cache.py failed: {proc.stderr[-2000:]}")
        log(f"service: scripts/torch_warm_cache.py --resolutions 3 "
            f"--autotune-kernels default: {time.perf_counter() - t0:.3f} s")
        for line in proc.stdout.splitlines():
            log(f"  {line}")
        g = torch.Generator(device="cuda").manual_seed(SEED)
        a = torch.randint(-128, 128, (128, 512), generator=g, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (512, 512), generator=g, device="cuda",
                          dtype=torch.int8)
        a_s = torch.rand(128, generator=g, device="cuda") + 0.01
        w_s = torch.rand(512, generator=g, device="cuda") + 0.01
        x = torch.randint(-2 ** 16, 2 ** 16, (256, 512), generator=g,
                          device="cuda", dtype=torch.int32)
        sa = torch.rand((1024, 256), generator=g, device="cuda") * 0.3 + 0.7
        sb = torch.randn((1024, 256), generator=g, device="cuda")
        h0 = torch.randn(256, generator=g, device="cuda")
        calls = {
            "dcim_mac": (lambda tc: dcim_matmul(a, w, a_s, w_s,
                                                tile_config=tc),
                         lambda: dcim_matmul_ref(a, w, a_s, w_s)),
            "csa_tree": (lambda tc: csa_tree_sum(x, tile_config=tc),
                         lambda: csa_tree_ref(x)),
            "ssm_scan": (lambda tc: ssm_scan(sa, sb, h0, tile_config=tc)[0],
                         lambda: ssm_scan_chunked_ref(
                             sa, sb, h0, ssm_chunks(1024, 256)[0])[0]),
        }
        autotune.clear_memo()
        autotune.set_registry(ArtifactRegistry(registry_root))
        try:
            for kernel, (run, plain) in calls.items():
                counter = get_registry().counter(
                    f"kernel/{kernel}/tile_source/registry")
                before = counter.value
                got = run("auto")
                check(counter.value == before + 1,
                      f"service: {kernel} tile_config=\"auto\" did not "
                      "resolve from the registry")
                check(torch.equal(got, plain()),
                      f"service: {kernel} with the registry's tile differs "
                      "from its plain version")
        finally:
            autotune.set_registry(None)
            autotune.clear_memo()
        log("service: tile_config=\"auto\" of dcim_matmul (128x512x512), "
            "csa_tree_sum (256 x 512) and ssm_scan (1024, 256) each resolved "
            "from the warmed registry (kernel/<k>/tile_source/registry +1), "
            "equal to the plain versions")

        # 4. selection through the frontend, from the warm cache
        t0 = time.perf_counter()
        sel = select_macros(serving["workloads"], service=front,
                            config=config,
                            kernel_fraction=serving["fraction"])
        wall = time.perf_counter() - t0
        front.close()
        _, labels = C.frontier_union(want, names)
        rg = serving["reports"]["cuda"]
        check(ws.fused_passes == 0, "service: selection ran an engine pass")
        check(list(sel.pool_labels) == labels, "service: pool labels differ")
        for wl in serving["workloads"]:
            check(sel.assignment[wl] == rg.best_for(wl)
                  and repr(sel.serving[wl].tokens_per_s)
                  == repr(serving["tokens_per_s"][wl]),
                  f"service: {wl}: selection differs from the serving "
                  "phase's co-design")
            log(f"service: select_macros: {wl} -> {sel.label_for(wl)}, "
                f"{sel.serving[wl].tokens_per_s!r} tokens/s at kernel "
                f"fraction {serving['fraction']!r} (== serving phase)")
        log(f"service: select_macros from the warm cache in {wall:.6f} s")

        # 5. the layout tail of the qwen3-4b pick
        ppa = sel.ppa_for("qwen3-4b")
        cpu_pick = C.frontier_union(results["cpu"])[
            serving["reports"]["cpu"].best_for("qwen3-4b")]
        texts = {}
        for what, emit in (
                ("RTL", C.emit_verilog),
                ("DEF", lambda p: layout.emit_def(layout.place(p))),
                ("SDP script", layout.emit_sdp_script)):
            texts[what] = emit(ppa)
            check(texts[what] == emit(cpu_pick),
                  f"service: {what} differs from the CPU run's pick")
        design = ppa.design
        nl = C.tree_netlist(design)
        rng = np.random.default_rng(SEED)
        ops = rng.integers(-8, 8, size=(nl.n_inputs, 1000))
        check(C.verify_tree(nl, ops), "service: gate-level check failed")
        for h in sorted({design.spec.h, 64, 256}):
            ops = rng.integers(-(2 ** 31) // 512, 2 ** 31 // 512,
                               size=(h, 4096))
            got = csa_tree_sum(torch.as_tensor(ops, dtype=torch.int32,
                                               device="cuda"))
            ref = gatesim.simulate(C.build_netlist(design.csa, h), ops)
            check(np.array_equal(got.cpu().numpy().astype(np.int64), ref),
                  f"service: csa_tree_sum at {h} rows differs from the "
                  "gate-level simulation")
        log(f"service: layout tail of {design.name()}: "
            + ", ".join(f"{k} {len(v.splitlines())} lines"
                        for k, v in texts.items())
            + " (== the CPU run's pick); gate-level check PASS; "
            f"csa_tree_sum == gatesim.simulate at "
            f"{sorted({design.spec.h, 64, 256})} rows")
    finally:
        engine.remove_latency_hook(hook)

    # 6. the quickstart
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines and lines[-1].endswith("PASS"),
          f"torch_quickstart.py failed: {proc.stdout[-1000:]}"
          f"{proc.stderr[-2000:]}")
    log(f"service: examples/torch_quickstart.py on the card: "
        f"{time.perf_counter() - t0:.3f} s, {lines[-1]}")
    return sel.label_for("qwen3-4b")


# ---------------------------------------------------------------------------
# 10. model
# ---------------------------------------------------------------------------

# The serving cells, each model at its full config: 4 prompts of 64
# tokens, then greedy decode steps (qwen3-4b 32, into a 96-token cache; the
# rest of the zoo 8, into 72); the decode-after-prefill checks prefill 65
# tokens.  The parameter counts are the reference's
# (tests/test_torch_models.py holds them equal).
MODEL_ARCHS = ("qwen3-4b", "granite-moe-3b-a800m", "rwkv6-7b", "zamba2-1.2b")
MODEL_BATCH, MODEL_PROMPT = 4, 64
MODEL_DECODE = {"qwen3-4b": 32, "granite-moe-3b-a800m": 8, "rwkv6-7b": 8,
                "zamba2-1.2b": 8}
MODEL_PARAMS = {"qwen3-4b": 4_411_424_256,
                "granite-moe-3b-a800m": 3_298_985_472,
                "rwkv6-7b": 7_534_546_944, "zamba2-1.2b": 1_170_313_344}
# Tolerances of the model phase, as shares of the reference logits' largest
# magnitude.  A bfloat16 path rounds to 8 bits of mantissa after every op
# and through 36 layers of fake-quant; a float32 path without fake-quant
# differs only by the order of float32 sums (TF32 off).  Wherever every
# logit moves by at most d, a row's argmax can change only if its top two
# differ by at most 2 d: rows with a wider gap must keep their argmax, and
# the others are ties within the two paths' rounding, printed.
BF16_TOL_FRAC = 0.1
F32_TOL_FRAC = 1e-4
# A reference MoE gate pair within EXPERT_TIE is a near-tie: card and CPU
# may route it either way.
EXPERT_TIE = 1e-6


def _launch_serve(args: list[str]) -> list[str]:
    """``python -m repro_torch.launch.serve`` on the card in a subprocess;
    its output lines."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                          + args, capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env=env)
    check(proc.returncode == 0,
          f"launch.serve failed: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return proc.stdout.splitlines()


def _same_logits(got, want, tol_frac: float, what: str) -> None:
    """``got`` within ``tol_frac`` of ``want``'s largest magnitude, and the
    same argmax in every row whose top-two gap exceeds twice the largest
    difference (module constants)."""
    import torch

    d = (got - want).abs().max().item()
    scale = want.abs().max().item()
    top = want.topk(2, -1).values
    decisive = (top[:, 0] - top[:, 1]) > 2 * d
    same = got.argmax(-1) == want.argmax(-1)
    log(f"model: {what}: max |diff| {d:.6g} of max |logit| {scale:.6f} "
        f"(tolerance {tol_frac} of it); argmax {got.argmax(-1).tolist()} / "
        f"{want.argmax(-1).tolist()}; rows with a top-two gap within 2 x "
        f"max |diff| (ties): {(~decisive).nonzero().flatten().tolist()}")
    check(d <= tol_frac * scale and bool(torch.all(same | ~decisive)),
          f"model: {what}: the logits differ")


@contextlib.contextmanager
def _recording_codes(codes: list):
    """A context in which every ``quantize_int`` call appends its int8
    codes (on the host) to ``codes``."""
    import repro_torch.quant.quantizers as Q

    orig = Q.quantize_int

    def rec(*a, **k):
        q, s = orig(*a, **k)
        codes.append(q.cpu())
        return q, s

    Q.quantize_int = rec
    try:
        yield
    finally:
        Q.quantize_int = orig


def _first_flip(got: list, want: list):
    """(call, codes flipped, codes) of the first quantizer call whose codes
    differ, or None; every difference there must be one code step."""
    check(len(got) == len(want), f"model: {len(got)} quantizer calls "
          f"against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        d = (a.int() - b.int()).abs()
        if d.any():
            check(d.max().item() == 1, f"model: quantizer call {i}: codes "
                  f"differ by {d.max().item()} steps")
            return i, int(d.ne(0).sum()), d.numel()
    return None


@contextlib.contextmanager
def _recording_experts(choices: list):
    """A context in which every MoE dispatch appends (gates, the experts
    chosen), on the host, to ``choices``."""
    import repro_torch.models.moe as moe

    orig = moe._top_k

    def rec(gates, k):
        v, i = orig(gates, k)
        choices.append((gates.cpu(), i.cpu()))
        return v, i

    moe._top_k = rec
    try:
        yield
    finally:
        moe._top_k = orig


def _first_expert_flip(got: list, want: list):
    """(dispatch, tokens routed otherwise, tokens) of the first MoE dispatch
    whose expert choices differ, or None; at every differing choice slot
    ``want``'s gates of the two experts must tie within EXPERT_TIE."""
    check(len(got) == len(want), f"model: {len(got)} MoE dispatches "
          f"against {len(want)}")
    for i, ((_, a), (gates, b)) in enumerate(zip(got, want)):
        rows = (a != b).any(-1).nonzero().tolist()
        for g, s in rows:
            gap = (gates[g, s][a[g, s]] - gates[g, s][b[g, s]]).abs().max()
            check(gap.item() <= EXPERT_TIE, f"model: MoE dispatch {i}, "
                  f"token {(g, s)}: experts {a[g, s].tolist()} against "
                  f"{b[g, s].tolist()}, gates apart by {gap.item():.3g}")
        if rows:
            return i, len(rows), a.shape[0] * a.shape[1]
    return None


def _logits_ok(logits, cfg) -> bool:
    """Finite over the vocabulary, the padding columns masked (float32's
    ``min`` cast to the logits' dtype: ``-inf`` in bfloat16)."""
    import torch

    pad = logits[..., cfg.vocab:].float()
    return bool(torch.isfinite(logits[..., :cfg.vocab]).all()
                and (pad <= torch.finfo(torch.float32).min).all())


def _serve_model(arch: str, card: str, work: Path, artifact: Path,
                 pick: str | None = None) -> None:
    """One model of MODEL_ARCHS on the card (module doc, phase 10): at full
    width through prefill and greedy decode, decode after a prefill held
    against the longer prefill at full width in float32 (not for MoE), the
    card against the CPU at 2 full-width layers in float32, and the
    launcher on the frontier store ``work``.  qwen3-4b (``pick``: the
    service phase's macro) adds the cache check in its bf16 config, the
    card against the CPU with fake-quant on, and a cold launch with the
    profile phase's ``artifact`` before the warm one."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import gemm_inventory
    from repro_torch.kernels.profile import fraction_from_profile_artifact
    from repro_torch.models import get_model, model_class
    from repro_torch.quant import fake_quant
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill, select_macros)
    from repro_torch.serve.step import greedy_argmax
    from repro_torch.service import FrontierCache, SynthesisService

    t_arch = time.perf_counter()
    main = pick is not None
    n_decode = MODEL_DECODE[arch]
    cfg = get_config(arch)
    api = get_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (MODEL_BATCH, MODEL_PROMPT + 1)),
                              device="cuda")

    def seeded():
        return torch.Generator(device="cuda").manual_seed(SEED)

    # -- 1. full width: init, prefill 4 x 64, greedy decode -----------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()       # earlier phases' results
    t0 = time.perf_counter()
    model = api.init_params(seeded(), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    layers = len(model.mamba if cfg.family == "hybrid" else model.blocks)
    check(layers == cfg.n_layers and n_params == MODEL_PARAMS[arch],
          f"model: {arch}: {layers} layers, {n_params} parameters")
    log(f"model: {arch} full width ({layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_padded}, {cfg.param_dtype}"
        + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} x "
           f"{cfg.moe.d_expert}" if cfg.moe else "")
        + (f", ssm state {cfg.ssm.state} x head {cfg.ssm.head_dim}, chunk "
           f"{cfg.ssm.chunk}" if cfg.ssm else "")
        + (f", shared attention every {cfg.attn_every}" if cfg.attn_every
           else "")
        + f"): {n_params} parameters, {weight_bytes} bytes, drawn on the "
        f"card in {t_init:.3f} s")
    prefill = make_prefill(api, MODEL_PROMPT + n_decode)
    decode = make_decode_step(api)
    # one untimed pass first: cuBLAS handles and first launches
    _, warm = prefill(model, prompts[:, :MODEL_PROMPT])
    decode(model, warm, prompts[:, :1])
    del warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(model, prompts[:, :MODEL_PROMPT])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    check(logits.shape == (MODEL_BATCH, MODEL_PROMPT, cfg.vocab_padded)
          and _logits_ok(logits, cfg),
          f"model: {arch}: prefill logits {tuple(logits.shape)}, finite "
          f"over the vocabulary and padding masked "
          f"{_logits_ok(logits, cfg)}")
    last = logits[:, -1].float()
    tok = greedy_argmax(logits)
    out, steps = [tok], []
    t0 = time.perf_counter()
    for _ in range(n_decode):
        logits, state = decode(model, state, tok)
        tok = greedy_argmax(logits)
        out.append(tok)
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    check(int(state["pos"]) == MODEL_PROMPT + n_decode
          and all(x.shape == (MODEL_BATCH, 1, cfg.vocab_padded)
                  for x in steps)
          and _logits_ok(torch.cat(steps, 1), cfg),
          f"model: {arch}: decode logits of the wrong shape or not finite")
    peak = torch.cuda.max_memory_allocated()
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"model: {arch} on {card}: init {t_init:.3f} s; prefill "
        f"{MODEL_BATCH}x{MODEL_PROMPT} tokens {t_prefill * 1e3:.3f} ms; "
        f"decode {n_decode} steps {t_decode * 1e3:.3f} ms, "
        f"{t_decode * 1e3 / n_decode:.3f} ms per step, "
        f"{MODEL_BATCH * n_decode / t_decode:.1f} tokens/s; bound "
        f"{bound_ms:.3f} ms per step (every weight byte read once at 3.35 "
        f"TB/s); peak memory {peak} bytes ({held} of them held before "
        f"init)")
    log(f"model: {arch}: first 16 tokens of row 0: "
        f"{torch.cat(out, 1)[0, :16].tolist()}")
    del logits, state, steps, out
    if main:
        # the cache in the config: prefill S - 1 and one decode step
        # against prefill S (the timed prefill's last logits)
        _, st = api.prefill(model, prompts[:, :MODEL_PROMPT - 1],
                            MODEL_PROMPT)
        got, _ = api.decode_step(model, st,
                                 prompts[:, MODEL_PROMPT - 1:MODEL_PROMPT])
        _same_logits(got[:, -1].float(), last, BF16_TOL_FRAC,
                     f"{arch}: decode after prefill {MODEL_PROMPT - 1} "
                     f"against prefill {MODEL_PROMPT}, the config "
                     f"({cfg.param_dtype}, fake-quant)")
        del got, st
    if cfg.family in ("ssm", "hybrid"):
        # a chunk of 256 tokens: the reference's chunked scan may leave
        # float32 there (ROADMAP.md, "Reference state"); printed, not gated
        long = torch.as_tensor(rng.integers(0, cfg.vocab, (MODEL_BATCH, 256)),
                               device="cuda")
        lg, _ = api.prefill(model, long, 256)
        bad = (~torch.isfinite(lg[..., :cfg.vocab])).any(-1).any(0)
        log(f"model: {arch}: prefill of {MODEL_BATCH}x256 tokens in the "
            f"config: finite {not bool(bad.any())}; {int(bad.sum())} of "
            f"256 positions with a non-finite logit")
        del lg, bad
    del model, last
    torch.cuda.empty_cache()

    # -- 2. decode continues prefill: float32, fake-quant off, full width ---
    if cfg.family != "moe":
        # MoE is left out: a decode step's tokens form another group, with
        # another capacity, than the prefill's (ROADMAP.md, "Reference
        # state")
        api32 = get_model(cfg.replace(param_dtype="float32",
                                      compute_dtype="float32",
                                      dcim_enabled=False))
        exact = api32.init_params(seeded(), device="cuda")
        want, _ = api32.prefill(exact, prompts, MODEL_PROMPT + 1)
        _, st = api32.prefill(exact, prompts[:, :-1], MODEL_PROMPT + 1)
        got, _ = api32.decode_step(exact, st, prompts[:, -1:])
        v = cfg.vocab
        _same_logits(got[:, -1, :v].float(), want[:, -1, :v].float(),
                     F32_TOL_FRAC,
                     f"{arch}: decode after prefill {MODEL_PROMPT} against "
                     f"prefill {MODEL_PROMPT + 1}, full width in float32, "
                     f"fake-quant off")
        del exact, want, got, st
        torch.cuda.empty_cache()

    # -- 3. card against CPU at 2 full-width layers, float32 ----------------
    t0 = time.perf_counter()
    cfg2 = cfg.replace(n_layers=2, param_dtype="float32",
                       compute_dtype="float32")
    small = prompts[:2, :32]
    for dcim in ((False, True) if main else (False,)):
        api2 = get_model(cfg2.replace(dcim_enabled=dcim))
        gpu = api2.init_params(seeded(), device="cuda")
        cpu = model_class(api2.cfg)(api2.cfg, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        what = (f"{arch}: card against CPU, 2 full-width layers in float32, "
                f"fake-quant {'on' if dcim else 'off'}, prompts 2x32")
        if dcim:
            # the quantizer on the card equals the CPU's on every weight
            linears = [(name, wg, wc) for (name, wg), wc in
                       zip(gpu.named_parameters(), cpu.parameters())
                       if name.endswith(".w") and name.startswith("blocks")]
            for name, wg, wc in linears:
                check(torch.equal(fake_quant(wg, 8, 0).cpu(),
                                  fake_quant(wc, 8, 0)),
                      f"model: fake_quant of {name} on the card differs "
                      "from the CPU's")
        codes, choices, runs = ([], []), ([], []), []
        for i, (m, x) in enumerate(((gpu, small), (cpu, small.cpu()))):
            with _recording_codes(codes[i]), _recording_experts(choices[i]):
                lg, _ = api2.prefill(m, x, 40)
                runs.append((lg[:, -1, :cfg.vocab].cpu(), None if dcim else
                             greedy_generate(api2, m, x, 8).cpu()))
        (got, gen_card), (want, gen_cpu) = runs
        flip = _first_flip(*codes)
        expert = _first_expert_flip(*choices)
        if dcim:
            # one weight code step moves an activation by 1/127 of its
            # row's range, and random weights carry it through; the
            # first differing quantizer call must differ by single steps
            d = (got - want).abs().max().item()
            log(f"model: {what}: weight fake-quant equal on all "
                f"{len(linears)} linears; first activation flip "
                f"{'none' if flip is None else flip} (call, codes "
                f"flipped, codes); logits max |diff| {d:.6f} of "
                f"{want.abs().max().item():.6f}")
        elif expert is None:
            check(flip is None, f"model: {what}: codes differ")
            _same_logits(got, want, F32_TOL_FRAC, what)
            log(f"model: {what}: 8 greedy tokens {gen_card.tolist()} / "
                f"{gen_cpu.tolist()}"
                + (f"; expert choices equal in all {len(choices[0])} "
                   "dispatches" if cfg.family == "moe" else ""))
            check(torch.equal(gen_card, gen_cpu),
                  f"model: {arch}: the card's greedy tokens differ from the "
                  "CPU's")
        else:
            # a near-tie routed otherwise moves whole expert outputs: printed
            d = (got - want).abs().max().item()
            log(f"model: {what}: expert choice flip {expert} (dispatch, "
                f"tokens routed otherwise, tokens), a near-tie within "
                f"{EXPERT_TIE}; logits max |diff| {d:.6g}; greedy "
                f"{gen_card.tolist()} / {gen_cpu.tolist()}")
        del gpu, cpu, got, want, lg, runs
        torch.cuda.empty_cache()
    log(f"model: {arch}: card against CPU {time.perf_counter() - t0:.3f} s")

    # -- 4. the launcher at the full config, on the frontier store ----------
    args = ["--arch", arch, "--decode-steps", str(n_decode), "--dcim-select",
            "--dcim-cache", str(work)]
    fraction = 1.0
    if main:
        args += ["--dcim-kernel-profile", str(artifact), "--batch",
                 str(MODEL_BATCH), "--prompt-len", str(MODEL_PROMPT)]
        fraction = fraction_from_profile_artifact(artifact)
    sel = None
    for launch in (("cold", "warm") if main else ("warm",)):
        t0 = time.perf_counter()
        lines = _launch_serve(args)
        wall = time.perf_counter() - t0
        for line in lines:
            log(f"  {line}")
        service = [ln for ln in lines if ln.startswith("dcim: synthesis")]
        check(len(service) == 1 and (
            "cold (hits=0 misses=4 fused_passes=1" in service[0]
            if launch == "cold" else
            "warm (hits=4 misses=0 fused_passes=0" in service[0]),
            f"model: {arch}: {launch} launch: {service}")
        if sel is None:
            # select_macros as the launcher calls it, from its warm store
            sel = select_macros(
                {cfg.name: gemm_inventory(cfg)}, kernel_fraction=fraction,
                service=SynthesisService(cache=FrontierCache(store_dir=work)))
        label = sel.label_for(cfg.name)
        text = "\n".join(lines)
        check(f"dcim: selected {label} for {cfg.name} " in text
              and pick in (None, label),
              f"model: {arch}: the launch selected other than "
              f"select_macros' {label} (the service phase's: {pick})")
        check(f"dcim: serving roofline "
              f"{sel.serving_for(cfg.name).tokens_per_s:.1f} tok/s" in text,
              f"model: {arch}: the launch's serving roofline differs from "
              "select_macros'")
        check(sum(ln.startswith(("prefill: ", "decode : ")) and
                  ln.endswith(f" on {torch.cuda.get_device_name(0)}")
                  for ln in lines) == 2,
              f"model: {arch}: the launch's times do not name the card")
        log(f"model: {arch}: launch.serve {launch}: {wall:.3f} s; selected "
            f"{label} (== select_macros'"
            + (", == the service phase's pick" if main else "")
            + f"), {sel.serving_for(cfg.name).tokens_per_s!r} tok/s at "
            f"kernel fraction {fraction!r}")
    log(f"model: {arch} in all {time.perf_counter() - t_arch:.3f} s")


def phase_model(pick: str, artifact: Path) -> None:
    """The port's model zoo on the card (module doc, phase 10): each of
    MODEL_ARCHS in turn, qwen3-4b first, through :func:`_serve_model` on
    one frontier store."""
    import shutil

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"model: {card}")
    work = ROOT / "build" / "model"
    shutil.rmtree(work, ignore_errors=True)
    for arch in MODEL_ARCHS:
        _serve_model(arch, card, work / "cache", artifact,
                     pick if arch == "qwen3-4b" else None)


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
    skeletons, artifact = phase_profile(wk)
    kernels += skeletons
    t7 = time.perf_counter()
    serving = phase_serving(chosen["results"], artifact)
    t8 = time.perf_counter()
    pick = phase_service(chosen["results"], serving)
    t9 = time.perf_counter()
    phase_model(pick, artifact)
    t10 = time.perf_counter()
    log(f"phases: device {t1 - t0:.3f} s, compiler {t2 - t1:.3f} s, "
        f"mac {t3 - t2:.3f} s, csa {t4 - t3:.3f} s, ssm {t5 - t4:.3f} s, "
        f"autotune {t6 - t5:.3f} s, profile {t7 - t6:.3f} s, serving "
        f"{t8 - t7:.3f} s, service {t9 - t8:.3f} s, model "
        f"{t10 - t9:.3f} s")
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
