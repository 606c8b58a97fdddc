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
               ``csa_tree``, ``dcim_mac`` or ``lattice_rollup`` kernel
               fails the run, as do a
               ``dcim_mac`` TMA kernel whose wgmma pipeline ptxas
               serialized or, where it has ``setmaxnreg``, whose registers
               are not the 168 its budget assumes);
  2. compiler  the compiler's batched main path on the four scenario specs
               at the full registered lattice (155,520 points per spec):
               ``mso_search_many`` and ``design_space_sweep_many(...)
               .frontier_indices()`` on the card, through its two CUDA
               kernels (A1 ``lattice_rollup``, one launch per spec group;
               A2 ``pareto_dominated``, one call per frontier, each a
               screen and a split kernel; their launch counts, by call and
               by pass, set to 0 before and read after), held bit for bit
               against the same calls with ``device="cpu"`` (the kernels'
               plain versions) and the search results against the scalar
               oracle; the sweep and the frontiers traced again, their
               device busy split into kernels and copies; the dominance
               kernel held against its plain version on the card on the
               edge sets of ``tests/torch_dominance_cases.py``; for each
               frontier, the candidates the screen pass left to the split
               pass, and each pass's time (CUDA events); each
               kernel held against and timed beside its plain version on
               the main path's inputs (A2: the calls of the counted run,
               recorded as it makes them), with its bound and, as its
               launches, the kernels by pass of the counted run; then the
               wide route of the dominance kernels (more objectives than
               the screen takes, or none): its edge sets (in the loop
               above) and its own main path, 8,192 near-tie points at 12
               objectives through ``batched.pareto_mask(device="cuda")``
               and ``nondominated_mask_sharded`` on four entries of card
               0, both equal to the host ``nondominated_mask`` bit for bit,
               its launches counted (``PASS_LAUNCHES["wide_screen"]`` and
               ``["wide_split"]``, set to 0 before and read after), its
               calls held against and timed beside the plain version, with
               their bound, each call's survivors and pass times logged;
               then 65,536 near ties at 16 objectives through both entry
               points, the ``pareto_mask`` call held against the plain
               version and timed with its bound, both masks held against
               the host mask (``nondominated_mask``'s two passes, their
               chunks over the host's cores: ``_host_mask``, itself held
               against ``nondominated_mask`` at 8,192 x 12);
  2b. shard    the sharded compiler engine on the card's mesh
               (``spec_sweep_mesh()``, every visible card) and on four
               entries of card 0 (``["cuda:0"] * 4``): a 130-spec request
               (``spec_variants(130, seed=0)``) at the compiler phase's full
               lattice through ``mso_search_many_sharded(mode="jit")`` equal
               to ``mso_search_many`` bit for bit (both wall times, the peak
               device memory, and the characterisation time against the
               traced execute's device busy time printed); the 13-spec
               ragged drill in jit, pmap and multihost on four entries
               equal to the unsharded pass; A3, the sharded frontier mask,
               through ``design_space_sweep_many_sharded`` of the four
               scenario specs on both meshes (the ``pareto_dominated``
               kernel, one phase-1 and one phase-2 call per entry and
               frontier, counted by call and by pass; the survivors and
               the passes' device time of the card's mesh's calls
               logged), its frontiers equal to the compiler
               phase's and its masks to the host mask, traced (device busy
               and kernels beside A2's), the two phases' calls of its run
               on the card's mesh, recorded as that run makes them, held
               against and timed beside their plain version, and its
               bound from the pairs those calls need;
               two gloo ranks (``torch.multiprocessing``, ``file://`` init
               in ``build/shard``), each its lane slice of the 13 specs on
               the card under ``mode="multihost"``, every rank's gathered
               result equal to the single-process pass; and a
               ``SynthesisService(mode="sharded")`` answering the four
               scenario specs in one sharded-jit pass, equal to the
               compiler phase's search;
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
 5b. fake_quant the DCIM fake-quant kernel at the decode cells' operands
               (granite-moe-3b-a800m at batch 1,024, zamba2-1.2b and
               rwkv6-7b's Finch at 512)
               in bfloat16 at 8 and 4 bits and in float32: result and
               codes equal to the plain version's on the card bit for bit;
               each operand's time beside the plain version's and the
               bytes bound;
 5c. moe_dispatch the MoE slot-assignment kernel at granite-moe-3b-
               a800m's decode (4 groups of 256 tokens) and prefill (256
               groups) shapes: dispatch, combine and held equal to the
               plain loop's on the CPU bit for bit, the seam's outputs
               (the load-balance loss too) to the loop's on the card; its
               time beside the loop's, the host's time to issue each, and
               the bytes bound;
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
               next, granite-moe-3b-a800m, rwkv6-7b, rwkv6-7b.finch (the
               ``rwkv6-7b.decode`` cell's configuration, Finch as
               published) and zamba2-1.2b, each at its full config (bf16)
               through one routine: the weights
               drawn on the card from a generator seeded 0 (layer and
               parameter counts checked and printed); prefill of 4 x 64
               tokens and greedy decode steps (32 for qwen3-4b, 8 for the
               rest; init s, prefill ms, decode ms per step, tokens/s, peak
               memory and the step's bound printed; logits finite over the
               vocabulary, the padding masked, of the right shapes); for
               rwkv6 and zamba2 whether a 4 x 256-token prefill in the
               config is finite (printed, not gated: the reference's
               chunked scan can leave float32 there; gated for Finch, whose
               chunk of 32 keeps it finite); for all but MoE, one
               decode step after a 64-token prefill against the 65-token
               prefill at full width in float32 without fake-quant (within
               F32_TOL_FRAC, the argmax kept wherever the top two are not
               tied within twice the difference); the config at 2 layers
               in float32 without fake-quant on the card against the CPU
               (within F32_TOL_FRAC and 8 greedy tokens equal, unless an
               MoE expert choice flipped, which must then be a near-tie of
               the CPU's gates within EXPERT_TIE and is printed); and
               ``python -m repro_torch.launch.serve --arch <model>
               --dcim-select`` (not for Finch, which no launcher builds)
               at the full config as a subprocess on one
               frontier store, its selection and tokens/s bound equal to
               ``select_macros``' and its times naming the card.  qwen3-4b
               adds: the cache check in the config (prefill of 63 tokens
               plus one decode step against the prefill of 64, within
               BF16_TOL_FRAC); the card against the CPU with fake-quant on
               (every weight's fake-quant equal, the first differing
               activation quantizer call off by single code steps); and a
               cold launch with the profile phase's artifact before the
               warm one (one fused pass cold, none warm, the service
               phase's pick).  Its hand-written kernels are the
               fake-quant's and the MoE slot assignment's: the full-width
               decode steps launch the first once per fake-quant call,
               MODEL_FAKE_QUANTS a step, split by route, and the second
               once per MoE layer a step (granite's 32); the models'
               products are ``torch.matmul`` and ``torch.einsum`` of
               fake-quantised operands, as the JAX models' are
               ``jnp.matmul`` and ``jnp.einsum``;
 11. train     the port's training path on the card (``repro_torch.train``,
               ``optim``, ``data``, ``ckpt``, the models' backward under
               remat): (a) for each of the ten smoke configs, one
               ``make_train_step`` step of 8 x 16 tokens on the card
               against the same step on the CPU from the same parameters
               (drawn on the CPU, seed 0) and batch, loss, grad norm and
               every parameter, ``m`` and ``v`` within TRAIN_LOSS /
               TRAIN_LEAF, or, where a fake-quant code or an MoE expert
               choice of the forward passes flipped (recorded, printed),
               within the TRAIN_FLIP_* tolerances; (b) ``python -m
               repro_torch.launch.train --arch llama3.2-3b --steps 6
               --batch 4 --seq 512 --microbatches 2`` at full width (28
               layers, 3.21e9 parameters in bf16, 2,048 tokens per step)
               as a subprocess, its printed losses finite and falling, then
               the same run in this process: every loss and grad norm
               finite, the last loss below the first, step 0's loss the
               launcher's; ms per step, tokens/s, peak device memory, one
               traced step's device busy share and the step's bound
               printed beside the card's name and power limit; (c) the
               restart drill (``examples/torch_fault_tolerance_drill.py``,
               failures at steps 7 and 13) on the card under
               ``torch.use_deterministic_algorithms``: the final parameters
               and moments equal the failure-free run's.  No hand-written
               kernel runs here either: the reference's training path calls
               none;
 12. scale     scale-out on the card (``repro_torch.parallel``,
               ``optim.compression``, ``ckpt.elastic``, ``launch.mesh``,
               the launchers under ``torch.distributed.run``).  NCCL
               refuses two ranks on one card, so every group of two or
               more ranks here is gloo, each rank's tensors on cuda:0
               (printed), and (f) opens the launchers' default NCCL group
               on one rank: (a) which
               collectives gloo runs on CUDA tensors (all-gather,
               reduce-scatter, all-reduce SUM and MAX, broadcast; float32,
               bfloat16, int32), each result printed, all must be right;
               (b) ``python -m torch.distributed.run --nproc-per-node 4 -m
               repro_torch.launch.train --arch llama3.2-3b --mesh 2x2
               --backend gloo --steps 2 --batch 4 --seq 512
               --microbatches 2`` at full width: finite losses, step 0's
               within SCALE_LOSS of the train phase's one-device step 0,
               every rank holding a quarter of every leaf sharded over both
               axes; ms per step, each rank's peak device memory and the
               collective bytes per step printed; (c)
               ``compressed_all_reduce_tree`` on 4 ranks, CUDA tensors
               against CPU tensors, bit for bit; (d) the elastic drill at
               the smoke config: 2 steps on 2x2 and the next, whose losses
               are held against one device's run of the same batches
               (SCALE_STEP_LOSS before the first fake-quant code flip,
               SCALE_FLIP_LOSS from it), saved on 2x2, restored onto 2x1
               and onto one device, every leaf bit for bit; (e) ``launch.serve``
               qwen3-4b at full width on a 2x1 mesh of 2 ranks, prompts 4 x
               64, 8 decode steps: the greedy tokens equal the model
               phase's one-device launch; (f) ``launch.train --arch
               llama3.2-3b --smoke --steps 2`` and ``launch.serve --arch
               qwen3-4b --smoke`` under ``torch.distributed.run`` on one
               rank with no ``--backend`` (the default, ``nccl``), the
               backend each reports printed and required to be ``nccl``,
               their losses (as printed, within a unit of the last digit)
               and sampled tokens equal to the same launches without a
               group.  (a), (c) and (d)'s save share one group of 4
               ranks.  No hand-written kernel runs here:
               the reference's scale-out path calls none;
 13. dryrun    the dry run (``repro_torch.launch.dryrun``: the port's
               step traced on meta tensors for rank 0 of a fake process
               group, nothing run on the card) held against what the card
               measured in this run: (a) the train phase's one-device cell
               (llama3.2-3b at full width, 4 x 512 tokens, 2 microbatches):
               the predicted peak memory within DRYRUN_MEM of the train
               phase's measured peak, the dry run's roofline terms printed
               beside the measured ms per step and busy share; (b) the
               scale phase's 2x2 cell: the bytes handed to the collectives
               per rank per step equal to the launcher's ``mesh:`` line for
               every rank, the predicted peak within DRYRUN_MEM of each
               rank's; (c) ``python -m repro_torch.launch.dryrun --arch
               qwen3-4b --shape decode_32k --mesh single`` (256 ranks) as a
               subprocess: its record ``ok``, printed with its trace time.
               It launches no hand-written kernel;
 14. report    one ``{"kernels": [...]}`` line, then as the last line
               ``{"ok": true, "device": {...}}``.

Each of phases 2, 2b, 3-5 and 7 sets its kernels' launch counts to 0 just
before its main path and reads them just after (phase 7 twice: K1 through
``profile_kernel``, then K2, the float32 / bfloat16 ``dcim_mac`` skeletons,
timed at the six qwen3-4b GEMMs), and phase 10 the fake-quant's around
each model's full-width decode loop; every kernel must have launched.

It needs one CUDA card and exits non-zero without one, and when it does not
sit at the root of a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
            check(not lib.name.startswith(
                      ("libcsa_tree", "libdcim_mac", "liblattice_rollup",
                       "libfake_quant"))
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


def _busy_s(spans) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us * 1e-6


def _device_split(fn) -> tuple[float, dict]:
    """``(wall_s, {kind: (device_busy_s, events)})`` of one traced ``fn()``
    call: the union of the device intervals ``torch.profiler`` records, in
    all (``all``) and by kind (``kernel``; ``memcpy``, a host <-> device or
    device copy; ``memset``), over the host wall time of the traced window
    (tracing overhead included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {"all": [], "kernel": [], "memcpy": [], "memset": []}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        kind = ("memcpy" if e.name.startswith("Memcpy")
                else "memset" if e.name.startswith("Memset") else "kernel")
        spans["all"].append(span)
        spans[kind].append(span)
    return wall, {k: (_busy_s(v), len(v)) for k, v in spans.items()}


def _device_profile(fn) -> tuple[float, float, int]:
    """``(wall_s, device_busy_s, events)`` of one traced ``fn()`` call: the
    union of every device interval (kernels and copies) of
    :func:`_device_split`."""
    wall, split = _device_split(fn)
    return (wall, *split["all"])


def phase_compiler() -> dict:
    import torch

    import repro_torch.core as C
    from repro_torch.core import engine as E
    from repro_torch.core import pareto as P
    from repro_torch.core import subcircuits as sc
    from repro_torch.kernels.lattice_rollup import kernel as rollup_kernel
    from repro_torch.kernels.pareto_dominated import kernel as dom_kernel
    from torch_dominance_cases import dominance_cases

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
    groups = []
    count_groups = lambda plan: groups.extend(plan.groups)
    for dev in ("cuda", "cpu"):
        record = contextlib.nullcontext([])
        if dev == "cuda":          # the main path's launches, counted
            rollup_kernel.LAUNCHES["rollup"] = 0
            dom_kernel.LAUNCHES.update(all=0, seg=0)
            dom_kernel.PASS_LAUNCHES.update(
                dict.fromkeys(dom_kernel.PASS_LAUNCHES, 0))
            E.add_execute_hook(count_groups)
            record = _recorded_dominance()
        with record as calls:
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
        if dev == "cuda":
            torch.cuda.synchronize()
            E.remove_execute_hook(count_groups)
            launches = {"rollup": rollup_kernel.LAUNCHES["rollup"],
                        **dom_kernel.LAUNCHES}
            passes = dict(dom_kernel.PASS_LAUNCHES)
            log(f"compiler[cuda]: launches on the main path {launches}, "
                f"dominance kernels by pass {passes} ({len(groups)} spec "
                f"groups, {len(fronts)} frontiers)")
            check(launches == {"rollup": len(groups), "all": len(fronts),
                               "seg": 0},
                  f"compiler: launches {launches}: want one roll-up per "
                  f"spec group ({len(groups)}) and one mask per frontier "
                  f"({len(fronts)})")
            check(len(calls) == len(fronts),
                  f"compiler: {len(calls)} dominance calls recorded for "
                  f"{len(fronts)} frontiers")
            check(passes == _passes_of(calls),
                  f"compiler: dominance kernels by pass {passes}, want "
                  f"{_passes_of(calls)}")
            a2_calls = calls
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
    # the lattice roll-up (A1 plus its host work and copies) and the
    # frontier masks (A2).  The busy share is taken against the untraced
    # wall time of the same call above; a first traced call absorbs the
    # tracer's start-up.
    _device_profile(lambda: torch.zeros(1, device="cuda"))
    traced = {}
    for what, fn in (
            ("design_space_sweep_many", lambda: C.design_space_sweep_many(
                specs, tech, config=config, device="cuda")),
            ("frontier_indices", lambda: [s.frontier_indices()
                                          for s in sw_g])):
        wall, split = _device_split(fn)
        busy, n = split["all"]
        traced[what] = (busy, n)
        log(f"compiler[cuda, traced]: {what}: device busy {busy:.6f} s over "
            f"{n} device events, {100 * busy / walls['cuda'][what]:.3f}% of "
            f"the untraced wall {walls['cuda'][what]:.6f} s (traced wall "
            f"{wall:.6f} s); by kind: " + ", ".join(
                f"{k} {b:.6f} s over {c}" for k, (b, c) in split.items()
                if k != "all"))

    # The A2 edge sets: the kernel against its plain version on the card
    eps = P.PARETO_EPS
    cases = dominance_cases(eps, SEED)
    for case in cases:
        rows = torch.as_tensor(case.rows, device="cuda")
        cands = torch.as_tensor(case.cands, device="cuda")
        check(torch.equal(P.dominated(rows, cands, eps, seg=case.seg),
                          P.dominated_ref(rows, cands, eps, seg=case.seg)),
              f"compiler: pareto_dominated differs from its plain version "
              f"on {case.name}")
    log(f"compiler: pareto_dominated == its plain version on the card on "
        f"{len(cases)} edge sets ({', '.join(c.name for c in cases)})")
    wide = [c.name for c in cases
            if not 1 <= c.rows.shape[1] <= dom_kernel.MAX_OBJECTIVES]
    log(f"compiler: of those, the wide route's ({len(wide)}, seg 0 and "
        f"seg > 0): {', '.join(wide)}")
    _dominance_passes("compiler: A2", a2_calls)
    # the row's launches are kernels (screen and split), not calls
    kernels = [_a1_row(specs, tech, config, launches["rollup"]),
               _a2_row(a2_calls, sum(passes.values()))]
    kernels.append(_wide_main_path())
    return {"language": res_g[names.index("language")],
            "results": {"cuda": res_g, "cpu": res_c}, "fronts": fr_g,
            "a2_traced": traced["frontier_indices"], "kernels": kernels}


# The wide route's main path: near-tie points at more objectives than the
# screen and split kernels take (tests/torch_dominance_cases.py), and a
# second, larger size, one pareto_mask call and the sharded mask
WIDE_POINTS, WIDE_OBJECTIVES = 8192, 12
WIDE_LARGE_POINTS, WIDE_LARGE_OBJECTIVES = 65_536, 16


def _host_mask(objs: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """The host's non-dominated mask of ``objs``: the two passes of
    ``core.pareto.nondominated_mask`` (each block of ``chunk`` points
    against itself, then the points that survive against every point, in
    chunks of ``chunk``) through the same ``chunk_dominated``, over a
    column-major copy so that each objective's column is read in order,
    the chunks of each pass spread over the host's cores (numpy releases
    the GIL in them).  The same verdicts as ``nondominated_mask``, in a
    fraction of its wall time at 65,536 points."""
    from repro_torch.core import pareto as P

    objs = np.asfortranarray(objs, dtype=np.float64)
    workers = min(8, len(os.sched_getaffinity(0)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        keep = ~np.concatenate(list(pool.map(
            lambda s: P.chunk_dominated(objs[s:s + chunk],
                                        objs[s:s + chunk], P.PARETO_EPS),
            range(0, len(objs), chunk))))
        survivors = np.flatnonzero(keep)
        parts = list(pool.map(
            lambda s: P.chunk_dominated(objs, objs[survivors[s:s + chunk]],
                                        P.PARETO_EPS),
            range(0, survivors.size, chunk)))
    if parts:
        keep[survivors] = ~np.concatenate(parts)
    return keep


def _wide_main_path() -> dict:
    """The dominance kernels' wide route on its main path: the public
    ``batched.pareto_mask(device="cuda")`` (A2's route) and
    ``nondominated_mask_sharded`` on four entries of card 0 (A3's) over
    WIDE_POINTS seeded near-tie points at WIDE_OBJECTIVES objectives, each
    mask equal to the host ``nondominated_mask`` bit for bit; the wide
    kernels' launches counted around both (set to 0 before, read after),
    their calls recorded, held against the plain version and timed beside
    it, with their bound, and each call's survivors and pass times logged.
    Then WIDE_LARGE_POINTS near ties at WIDE_LARGE_OBJECTIVES objectives
    through both entry points, its ``pareto_mask`` call held against the
    plain version and timed, with its bound, and both masks held against
    the host mask (:func:`_host_mask`, held against ``nondominated_mask``
    on the first set).  Returns the kernels-line row."""
    import torch

    from repro_torch.core import batched as B
    from repro_torch.core import pareto as P
    from repro_torch.kernels.pareto_dominated import kernel as dom_kernel
    from repro_torch.parallel import spec_sweep_mesh
    from torch_dominance_cases import wide_tie_points

    t_step = time.perf_counter()
    objs = wide_tie_points(WIDE_POINTS, WIDE_OBJECTIVES, P.PARETO_EPS, SEED)
    t0 = time.perf_counter()
    host = P.nondominated_mask(objs)
    t_host = time.perf_counter() - t0
    check(np.array_equal(_host_mask(objs), host), "compiler: wide route: "
          "_host_mask differs from nondominated_mask")
    mesh = spec_sweep_mesh(["cuda:0"] * 4)
    dom_kernel.LAUNCHES.update(all=0, seg=0)
    dom_kernel.PASS_LAUNCHES.update(
        dict.fromkeys(dom_kernel.PASS_LAUNCHES, 0))
    with _recorded_dominance() as calls:
        t0 = time.perf_counter()
        mask = B.pareto_mask(objs, device="cuda")
        t1 = time.perf_counter()
        sharded = P.nondominated_mask_sharded(objs, mesh=mesh)
        t2 = time.perf_counter()
    torch.cuda.synchronize()
    launches = dict(dom_kernel.LAUNCHES)
    passes = dict(dom_kernel.PASS_LAUNCHES)
    kernels = passes["wide_screen"] + passes["wide_split"]
    check(passes == _passes_of(calls)
          and passes["wide_screen"] == len(calls) > 0
          and passes["screen"] == passes["split"] == 0,
          f"compiler: wide route: kernels by pass {passes} from "
          f"{len(calls)} calls, want {_passes_of(calls)}")
    check(launches == {"all": 5, "seg": 4},
          f"compiler: wide route: calls {launches}, want one all-rows call "
          f"for pareto_mask and two per entry for the sharded mask")
    kept = int(host.sum())
    check(0 < kept < len(objs), f"compiler: wide route: {kept} of "
          f"{len(objs)} points not dominated")
    check(np.array_equal(mask, host), "compiler: wide route: "
          "pareto_mask(device='cuda') differs from the host mask")
    check(np.array_equal(sharded, host), "compiler: wide route: the "
          "sharded mask on four entries differs from the host mask")
    row, pairs = _dominance_row("pareto_dominated_wide",
                                "src/repro/core/pareto.py:52", calls,
                                kernels, plain_reps=3)
    log(f"compiler: wide route, {WIDE_POINTS} x {WIDE_OBJECTIVES} near-tie "
        f"points ({kept} not dominated, {len(objs) - kept} dominated): "
        f"pareto_mask(device='cuda') {t1 - t0:.6f} s and the sharded mask "
        f"on 4 entries {t2 - t1:.6f} s of wall, the host mask "
        f"{t_host:.6f} s (_host_mask equal to it); all three equal bit "
        f"for bit; {len(calls)} calls "
        f"(seg {[c[3] for c in calls]}), kernels by pass {passes}; "
        f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}, the {pairs} pairs "
        f"these data need); {row['max_abs_err']} verdicts differ from the "
        f"plain version")
    _dominance_passes("compiler: wide route", calls)

    # the second size
    big = wide_tie_points(WIDE_LARGE_POINTS, WIDE_LARGE_OBJECTIVES,
                          P.PARETO_EPS, SEED)
    with _recorded_dominance() as calls:
        t0 = time.perf_counter()
        mask = B.pareto_mask(big, device="cuda")
        t1 = time.perf_counter()
    sharded = P.nondominated_mask_sharded(big, mesh=mesh)
    t2 = time.perf_counter()
    host = _host_mask(big)
    t_host = time.perf_counter() - t2
    check(np.array_equal(mask, host) and np.array_equal(sharded, host),
          f"compiler: wide route at {WIDE_LARGE_POINTS} x "
          f"{WIDE_LARGE_OBJECTIVES}: the masks from the card differ from "
          "the host mask")
    ((rows, cands, eps, seg, chunk, got),) = calls
    t3 = time.perf_counter()
    want = P.dominated_ref(rows, cands, eps, seg, chunk)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t3
    err = int((got != want).sum())
    check(err == 0, f"compiler: wide route at {WIDE_LARGE_POINTS} x "
          f"{WIDE_LARGE_OBJECTIVES}: {err} verdicts differ from the plain "
          "version")
    ms = _time_ms(lambda: P.dominated(rows, cands, eps, seg, chunk), reps=5)
    stats = {}
    dom_kernel.pareto_dominated_cuda(rows, cands, eps, seg, stats=stats)
    torch.cuda.synchronize()
    e = stats["events"]
    bound, by, big_pairs = _dominance_bound_ms(calls)
    log(f"compiler: wide route, {WIDE_LARGE_POINTS} x "
        f"{WIDE_LARGE_OBJECTIVES} near-tie points "
        f"({int(host.sum())} not dominated): "
        f"pareto_mask(device='cuda') {t1 - t0:.6f} s and the sharded mask "
        f"on 4 entries {t2 - t1:.6f} s of wall, both equal to the host "
        f"mask bit for bit (_host_mask {t_host:.3f} s of wall); its "
        f"call {ms:.6f} ms (the screen left "
        f"{int(stats['survivors'].item())} survivors; screen "
        f"{e[0].elapsed_time(e[1]):.6f} ms, split "
        f"{e[1].elapsed_time(e[2]):.6f} ms in one run), bound "
        f"{bound:.6f} ms ({by}, the {big_pairs} pairs these data need); "
        f"the plain version once {t_plain:.3f} s of wall, 0 verdicts "
        f"differ; the wide step {time.perf_counter() - t_step:.3f} s of wall")
    return row


def _same_bits(a, b) -> bool:
    """Equal shape and bits of two float64 tensors (NaN included)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


def _max_abs_err(a, b) -> float:
    """Largest |a - b| of two float tensors of one shape: 0 where both are
    equal (infinities included) or both NaN, inf where only one is NaN."""
    import torch
    same = (a == b) | (a.isnan() & b.isnan())
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.nan_to_num(nan=float("inf")).max()) if diff.numel() \
        else 0.0


def _a1_groups(specs, tech, config) -> list:
    """The packed spec groups of ``design_space_sweep_many(specs, tech,
    config=config)``: the main path's roll-up operands."""
    import repro_torch.core.engine as E
    from repro_torch.core import batched as B

    plan = E.plan(specs, tech, B.MEMCELLS, config=config, device="cpu")
    return [E.pack_group([plan.lattices[i] for i in group],
                         [plan.tables[i] for i in group])
            for group in plan.groups]


def _a1_row(specs, tech, config, launches: int) -> dict:
    """A1 on the card: the kernel's roll-up of each spec group held bit for
    bit against its plain version (``_eval_kernel``) on the same operands,
    and both timed (the copies to the card excluded)."""
    import torch

    import repro_torch.core.engine as E
    from repro_torch.core import batched as B

    groups = _a1_groups(specs, tech, config)
    ops = []
    for packed in groups:
        tabs, consts, e_ofu, e_align = packed.operands
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                        device="cuda")
        ops.append((E._gather_index(packed, torch.device("cuda")),
                    tuple(f64(t) for t in tabs), f64(consts), f64(e_ofu),
                    f64(e_align)))
    err = 0.0
    for o in ops:
        got, want = B.eval_lattice(*o), B._eval_kernel(*o)
        outputs = [(k, got[k], want[k])
                   for k in ("mac_base", "ofu_base", "area", "e_cycle")]
        outputs += [(f"breakdown {k}", got["breakdown"][k], v)
                    for k, v in want["breakdown"].items()]
        for k, g, w in outputs:
            check(_same_bits(g, w), f"compiler: lattice_rollup {k} differs "
                  "from its plain version")
            err = max(err, _max_abs_err(g, w))
    ms = sum(_time_ms(lambda o=o: B.eval_lattice(*o)) for o in ops)
    plain = sum(_time_ms(lambda o=o: B._eval_kernel(*o), reps=5)
                for o in ops)
    bound, by = _a1_bound_ms(groups)
    points = sum(len(p) * len(p.idx[0]) for p in groups)
    log(f"compiler: A1 lattice_rollup ({len(groups)} group, {points} "
        f"(spec, point) pairs): {ms:.6f} ms, plain {plain:.6f} ms, bound "
        f"{bound:.6f} ms ({by}); equal to the plain version bit for bit "
        f"(max abs err {err})")
    return {"name": "lattice_rollup", "route": "cuda",
            "source": "src/repro_torch/csrc/lattice_rollup.cu",
            "replaces": "src/repro/core/batched.py:612", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _frontier_objs(sweep) -> np.ndarray:
    """The objectives ``sweep.frontier_indices()`` masks: its feasible
    valid points, or every valid point where none is feasible."""
    cand = np.flatnonzero(sweep.lattice.valid & sweep.ppa.meets)
    if cand.size == 0:
        cand = np.flatnonzero(sweep.lattice.valid)
    return sweep.objectives()[cand]


@contextlib.contextmanager
def _recorded_dominance():
    """Record every :func:`repro_torch.core.pareto.dominated` call made in
    the block, by the sharded mask and by ``batched.pareto_mask`` (which
    holds the function under its own name), as ``(rows, cands, eps, seg,
    chunk, verdicts)`` in call order.  The calls run as they would."""
    from repro_torch.core import batched as B
    from repro_torch.core import pareto as P

    calls, dominated = [], P.dominated

    def recording(rows, cands, eps=P.PARETO_EPS, seg=0, chunk=512):
        got = dominated(rows, cands, eps, seg, chunk)
        calls.append((rows, cands, eps, seg, chunk, got))
        return got

    P.dominated = B.dominated = recording
    try:
        yield calls
    finally:
        P.dominated = B.dominated = dominated


def _dominance_row(name: str, replaces: str, calls, launches: int,
                   plain_reps: int) -> tuple[dict, int]:
    """A kernels-line row of the dominance kernel from the main path's
    recorded ``calls``: each call's verdicts (the kernel's) held against
    its plain version on the same inputs, the number of verdicts that
    differ as the error, and both versions timed on those inputs.  Also
    returns the pair count of the bound."""
    from repro_torch.core import pareto as P

    err, ms, plain = 0, 0.0, 0.0
    for rows, cands, eps, seg, chunk, got in calls:
        want = P.dominated_ref(rows, cands, eps, seg, chunk)
        check(got.shape == want.shape and got.device == want.device,
              f"{name}: verdicts of shape {tuple(got.shape)} on "
              f"{got.device}, want {tuple(want.shape)} on {want.device}")
        err += int((got != want).sum())
        ms += _time_ms(lambda: P.dominated(rows, cands, eps, seg, chunk),
                       reps=10)
        plain += _time_ms(lambda: P.dominated_ref(rows, cands, eps, seg,
                                                  chunk), reps=plain_reps)
    check(err == 0, f"{name}: {err} verdicts of the main path differ from "
          "the plain version")
    bound, by, pairs = _dominance_bound_ms(calls)
    return ({"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/pareto_dominated.cu",
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
             "library_ms": None}, pairs)


def _passes_of(calls) -> dict:
    """The dominance kernels, by pass, that the recorded ``calls`` launch
    (:func:`repro_torch.kernels.pareto_dominated.passes` of each)."""
    from repro_torch.kernels.pareto_dominated import PASS_LAUNCHES, passes

    out = dict.fromkeys(PASS_LAUNCHES, 0)
    for rows, cands, _, seg, _, _ in calls:
        for name in passes(rows.shape[0], cands.shape[0], seg,
                           rows.shape[1]):
            out[name] += 1
    return out


def _dominance_passes(label: str, calls, reps: int = 5) -> dict:
    """The two passes of the dominance kernel on the recorded ``calls``,
    each call again through the binding ``reps`` times: its verdicts equal
    to the recorded ones, its survivor count (the candidates the screen
    pass left to the split pass), and the median time of each pass from
    the CUDA events the binding records around them (the L2 cache flushed
    and the device spun before each call, as :func:`_time_ms` does, so
    that the host's launch work between the events is not counted)."""
    import torch

    from repro_torch.kernels.pareto_dominated import pareto_dominated_cuda
    from repro_torch.kernels.timing import FLUSH_BYTES, SPIN_CYCLES

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    left, ms = [], {"screen": [], "split": []}
    for rows, cands, eps, seg, _, got in calls:
        times = {"screen": [], "split": []}
        for _ in range(reps):
            stats = {}
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            again = pareto_dominated_cuda(rows, cands, eps, seg,
                                          stats=stats)
            torch.cuda.synchronize()
            check(torch.equal(again, got), f"{label}: the verdicts of a "
                  "repeat differ from the main path's")
            e = stats["events"]
            times["screen"].append(e[0].elapsed_time(e[1]))
            times["split"].append(e[1].elapsed_time(e[2]))
        left.append(int(stats["survivors"].item()))
        for kind in ms:
            ms[kind].append(float(np.median(times[kind])))
    log(f"{label}: {len(calls)} calls of {[c[1].shape[0] for c in calls]} "
        f"candidates (seg {[c[3] for c in calls]}), "
        f"{[int((~c[5]).sum()) for c in calls]} not dominated; the screen "
        f"pass left {left} to the split pass; per call (CUDA events, "
        f"median of {reps}): screen {[round(x, 6) for x in ms['screen']]} "
        f"ms, split {[round(x, 6) for x in ms['split']]} ms (sums "
        f"{sum(ms['screen']):.6f} and {sum(ms['split']):.6f} ms)")
    return {"survivors": left, "ms": ms}


def _a2_row(calls, launches: int) -> dict:
    """A2 on the card: the frontier masks' calls of the counted main path
    run, by the kernel and by its plain version (the chunked torch ops)."""
    row, pairs = _dominance_row("pareto_dominated",
                                "src/repro/core/pareto.py:52", calls,
                                launches, plain_reps=2)
    all_pairs, all_by, _ = _dominance_bound_ms(calls, all_pairs=True)
    log(f"compiler: A2 pareto_dominated (4 frontiers of "
        f"{[c[1].shape[0] for c in calls]} points, "
        f"{[int((~c[5]).sum()) for c in calls]} not dominated): "
        f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms; bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}, the {pairs} pairs "
        f"these data need), all-pairs bound {all_pairs:.6f} ms ({all_by}); "
        f"{row['max_abs_err']} verdicts differ from the plain version")
    return row


def _a1_bound_ms(groups) -> tuple[float, str]:
    """Least time of the lattice roll-up (A1) over the packed spec
    ``groups``: the int64 gather indices (shared by a group), the per-spec
    tables and the float64 outputs (mac_base, ofu_base, area, the five
    gathered area terms, one energy per mode) each moved once, against its
    float64 adds and multiplies (8 per point plus 9 per mode) at the FP64
    rate."""
    nbytes = ops = 0
    for packed in groups:
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


def _dominance_bound_ms(calls, all_pairs: bool = False
                        ) -> tuple[float, str, int]:
    """Least time of the recorded dominance ``calls`` (A2, A3) for this
    run's data: each call's rows and candidates read once (once in all
    where they are one tensor) and its verdicts written once, against two
    float64 compares (``<=`` and ``<`` with the eps band) per objective per
    pair the data need: a candidate that no row dominates is tested against
    every row of its test (all rows, or its block's with ``seg``), a
    dominated one against its one witness.  ``all_pairs`` counts every
    candidate against every row of its test.  Also returns the pair
    count."""
    nbytes = ops = pairs = 0
    for rows, cands, _, seg, _, got in calls:
        (n, k), c = rows.shape, cands.shape[0]
        if seg:
            start = np.arange(c) // seg * seg
            tested = np.minimum(start + seg, n) - start
        else:
            tested = np.full(c, n)
        kept = ~got.cpu().numpy()
        need = (int(tested.sum()) if all_pairs
                else int(tested[kept].sum()) + int((~kept).sum()))
        same = (rows.data_ptr() == cands.data_ptr()
                and rows.shape == cands.shape)
        pairs += need
        ops += 2 * k * need
        nbytes += 8 * k * (n + (0 if same else c)) + c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs)


# ---------------------------------------------------------------------------
# 2b. shard
# ---------------------------------------------------------------------------


def _result_texts(results) -> list[str]:
    """Search results as text: ``n_evaluated``, then every explored and
    frontier MacroPPA in order (``repr`` of ``asdict``: every float's bits
    and every dict's order, ``area_breakdown`` included)."""
    return [repr((r.n_evaluated, [_ppa_repr(p) for p in r.explored],
                  [_ppa_repr(p) for p in r.frontier])) for r in results]


def _shard_rank(rank: int, world: int, work: str) -> None:
    """One rank of the shard phase's gloo drill: its lane slice of the
    13-spec request on the card under ``mode="multihost"``, gathered over
    the group, written to ``work/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{work}/init",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        import repro_torch.core as C
        from repro_torch.core import subcircuits as sc
        from repro_torch.core.shardspec import (mso_search_many_sharded,
                                                spec_variants)
        from repro_torch.parallel import host_spec_mesh

        tech = C.calibrated_tech_for_reference()
        config = C.LatticeConfig(precision_modes=3,
                                 approx_cells=sc.APPROX_CELLS)
        mesh = host_spec_mesh(["cuda:0"])
        got = mso_search_many_sharded(spec_variants(13, seed=5), None, tech,
                                      config=config, mesh=mesh,
                                      mode="multihost")
        Path(work, f"rank{rank}.json").write_text(json.dumps({
            "mesh": list(mesh.devices.shape),
            "results": _result_texts(got)}))
    finally:
        dist.destroy_process_group()


def phase_shard(compiler: dict) -> list[dict]:
    """The sharded compiler engine on the card (module doc, phase 2b),
    held against the compiler phase's cuda results (themselves held bit for
    bit against ``device="cpu"``) and the unsharded engine."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    import repro_torch.core as C
    from repro_torch.core import engine as E
    from repro_torch.core import pareto as P
    from repro_torch.core import subcircuits as sc
    from repro_torch.core.shardspec import (design_space_sweep_many_sharded,
                                            mso_search_many_sharded,
                                            spec_variants)
    from repro_torch.parallel import host_spec_mesh, spec_sweep_mesh
    from repro_torch.kernels.pareto_dominated import kernel as dom_kernel
    from repro_torch.service import (FrontierCache, SynthesisRequest,
                                     SynthesisService)

    tech = C.calibrated_tech_for_reference()
    scl = C.SubcircuitLibrary(tech).build()
    config = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
    card, four = spec_sweep_mesh(), spec_sweep_mesh(["cuda:0"] * 4)
    log(f"shard: meshes: every card {[str(d) for d in card.devices.flat]}, "
        f"four entries {[str(d) for d in four.devices.flat]}")

    # 1. a 130-spec request at full width on the card's mesh
    specs = spec_variants(130, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = C.mso_search_many(specs, scl, tech, config=config, device="cuda")
    t1 = time.perf_counter()
    got = mso_search_many_sharded(specs, scl, tech, config=config,
                                  mesh=card, mode="jit")
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    n_points = 130 * len(C.DesignLattice.enumerate(specs[0], config=config))
    check(_result_texts(got) == _result_texts(ref),
          "shard: 130 specs: the sharded search differs from mso_search_many")
    t3 = time.perf_counter()
    plan = E.plan(specs, tech, (sc.MemCellKind.SRAM_6T,), mode="sharded-jit",
                  mesh=card, config=config)
    t_char = time.perf_counter() - t3
    wall, busy, n_k = _device_profile(lambda: E.execute(plan))
    log(f"shard: 130 specs x {n_points // 130} points ({n_points} in all, "
        f"{len(plan.groups)} group): mso_search_many {t1 - t0:.3f} s, "
        f"mso_search_many_sharded (jit, {card.devices.size} card) "
        f"{t2 - t1:.3f} s, bit for bit equal; peak device memory "
        f"{peak / 1e9:.3f} GB; characterisation (engine.plan) {t_char:.3f} "
        f"s against the traced execute: device busy {busy:.6f} s over "
        f"{n_k} kernels in {wall:.3f} s")
    del ref, got, plan

    # 2. every mode and the ragged split on four entries of the card
    specs = spec_variants(13, seed=5)
    ref = _result_texts(C.mso_search_many(specs, scl, tech, config=config,
                                          device="cuda"))
    walls = []
    for mode, mesh in (("jit", four), ("pmap", four),
                       ("multihost", host_spec_mesh(["cuda:0"] * 4))):
        t0 = time.perf_counter()
        got = mso_search_many_sharded(specs, scl, tech, config=config,
                                      mesh=mesh, mode=mode)
        walls.append(f"{mode} {time.perf_counter() - t0:.3f} s")
        check(_result_texts(got) == ref,
              f"shard: 13 specs in {mode} on {mesh.devices.shape} entries "
              "differ from mso_search_many")
    log(f"shard: 13 specs (ragged on 4 entries) in every mode equal to "
        f"mso_search_many: {', '.join(walls)}")

    # 3. A3 at lattice scale: the scenario sweeps' frontiers through the
    #    sharded mask, on the card's mesh and on four entries; the
    #    binding's calls (two per entry and frontier) and its kernels by
    #    pass counted around each
    scen = list(C.scenario_specs().values())
    for label, mesh in (("1 entry", card), ("4 entries", four)):
        sweeps = design_space_sweep_many_sharded(scen, tech, config=config,
                                                 mesh=mesh, mode="jit")
        dom_kernel.LAUNCHES.update(all=0, seg=0)
        dom_kernel.PASS_LAUNCHES.update(
            dict.fromkeys(dom_kernel.PASS_LAUNCHES, 0))
        t0 = time.perf_counter()
        with _recorded_dominance() as calls:
            fronts = [s.frontier_indices() for s in sweeps]
        t_front = time.perf_counter() - t0
        torch.cuda.synchronize()
        n_dev = mesh.devices.size
        got = dict(dom_kernel.LAUNCHES)
        passes = dict(dom_kernel.PASS_LAUNCHES)
        check(got == {"all": 4 * n_dev, "seg": 4 * n_dev}
              and len(calls) == 8 * n_dev,
              f"shard: A3 on {label}: launches {got} from {len(calls)} "
              f"calls, want one per phase, entry and frontier")
        check(passes == _passes_of(calls),
              f"shard: A3 on {label}: dominance kernels by pass {passes}, "
              f"want {_passes_of(calls)}")
        if mesh is card:           # the main path: the card's own mesh
            a3_calls, a3_launches = calls, sum(passes.values())
        check(fronts == compiler["fronts"],
              f"shard: A3 frontiers on {label} differ from the compiler "
              "phase's")
        objs_list = [_frontier_objs(s) for s in sweeps]
        masks = [P.nondominated_mask(o) for o in objs_list]
        check(all(np.array_equal(P.nondominated_mask_sharded(o, mesh=mesh),
                                 want)
                  for o, want in zip(objs_list, masks)),
              f"shard: A3's masks on {label} differ from the host mask")
        wall, split = _device_split(
            lambda: [s.frontier_indices() for s in sweeps])
        (busy, n_k), (k_busy, k_n) = split["all"], split["kernel"]
        bound, by, pairs = _dominance_bound_ms(calls)
        a2_busy, a2_kernels = compiler["a2_traced"]
        log(f"shard: A3 nondominated_mask_sharded on {label} "
            f"(4 frontiers): launches {got}, by pass {passes}; "
            f"frontier_indices "
            f"{t_front:.3f} s == the compiler phase's, masks == the host "
            f"mask; traced: device busy {busy:.6f} s over {n_k} device "
            f"events, kernels {k_busy:.6f} s over {k_n} ({wall:.3f} s "
            f"wall; A2 in the compiler phase: {a2_busy:.6f} s over "
            f"{a2_kernels} events); bound {bound:.6f} ms ({by}, {pairs} "
            f"pairs)")
    _dominance_passes("shard: A3 on 1 entry", a3_calls)
    row, pairs = _dominance_row("pareto_dominated_sharded",
                                "src/repro/core/pareto.py:164", a3_calls,
                                a3_launches, plain_reps=5)
    log(f"shard: A3 pareto_dominated, the {len(a3_calls)} calls (both "
        f"phases) of the 1-entry run: {row['ms']:.6f} ms, plain "
        f"{row['plain_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, the {pairs} pairs these data need); "
        f"{row['max_abs_err']} verdicts differ from the plain version")

    # 4. the multi-process branch: two gloo ranks on the one card
    work = ROOT / "build" / "shard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.spawn(_shard_rank, args=(2, str(work)), nprocs=2, join=False)
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  "shard: the 2-process drill did not finish in 300 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    for rank in range(2):
        out = json.loads((work / f"rank{rank}.json").read_text())
        check(out["mesh"] == [2, 1] and out["results"] == ref,
              f"shard: rank {rank}'s gathered result differs from the "
              "single-process pass")
    log(f"shard: 2 gloo ranks on the card, each its lane slice of 13 specs "
        f"(multihost): every rank's gathered result equal to the "
        f"single-process pass ({time.perf_counter() - t0:.3f} s with "
        f"start-up)")

    # 5. the service in a sharded mode on the card
    modes = []
    hook = lambda plan: modes.append(plan.placement.mode)
    E.add_execute_hook(hook)
    try:
        svc = SynthesisService(mode="sharded",
                               cache=FrontierCache(store_dir=work / "store"))
        t0 = time.perf_counter()
        resp = svc.serve([SynthesisRequest(spec=s, config=config)
                          for s in scen])
        t_svc = time.perf_counter() - t0
    finally:
        E.remove_execute_hook(hook)
    check(modes == ["sharded-jit"] and svc.stats.fused_passes == 1,
          f"shard: service passes {modes}")
    check(_result_texts(r.result for r in resp)
          == _result_texts(compiler["results"]["cuda"]),
          "shard: the sharded service's frontiers differ from the compiler "
          "phase's")
    log(f"shard: SynthesisService(mode=\"sharded\") on the card: 4 scenario "
        f"specs in one sharded-jit pass, {t_svc:.3f} s, equal to the "
        f"compiler phase's search")
    return [row]


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


#: The decode cells' fake-quant operands (shape, axis).  granite-moe-3b-
#: a800m at batch 1,024: a token's activation row, the experts' input
#: (E, G, C, d), a K/V projection's weight, the experts' gate/up weights.
#: zamba2-1.2b at batch 512: the Mamba2 input projection's activation and
#: (2048, 8384) weight, the output projection's activation and weight.
#: rwkv6-7b (Finch) at batch 512: the projections' activations (d and the
#: channel-mix's d_ff wide) and their (4096, 4096), (4096, 14336) and
#: (14336, 4096) weights, the last the cols route's longest columns.
FAKE_QUANT_SHAPES = {
    "granite-moe-3b-a800m": (((1024, 1536), -1), ((40, 4, 64, 1536), -1),
                             ((1536, 512), 0), ((40, 1536, 512), 1)),
    "zamba2-1.2b": (((512, 2048), -1), ((2048, 8384), 0),
                    ((512, 4096), -1), ((4096, 2048), 0)),
    "rwkv6-7b": (((512, 4096), -1), ((512, 14336), -1), ((4096, 4096), 0),
                 ((4096, 14336), 0), ((14336, 4096), 0)),
}


def phase_fake_quant() -> list[dict]:
    """The fake-quant kernel at the decode cells' operands in bfloat16 and
    8 bits (and each in float32 and at 4 bits): bit for bit the plain
    version's result and codes on the card; then its time beside the
    plain version's and the bytes bound (operand read once, result written
    once).  The row's times are granite's four operands; its launches are
    the model phase's (:func:`main` fills them in)."""
    import torch

    import repro_torch.quant.quantizers as Q
    from repro_torch.kernels.fake_quant import LAUNCHES, fake_quant_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = {}
    for arch, shapes in FAKE_QUANT_SHAPES.items():
        for shape, axis in shapes:
            x = torch.randn(shape, generator=g, device="cuda")
            keep = list(shape)
            keep[axis] = 1
            scale = torch.exp2(8 * torch.rand(keep, generator=g,
                                              device="cuda") - 4)
            inputs[(arch, shape, axis)] = (x * scale).to(torch.bfloat16)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    for (_, shape, axis), x in inputs.items():
        for xt, bits in ((x, 8), (x, 4), (x.float(), 8)):
            got, codes = fake_quant_cuda(xt, bits, axis, codes=True)
            q, _ = Q.quantize_int(xt, bits, axis)
            want = Q._fake_quant_ref(xt, bits, axis)
            check(torch.equal(got, want) and torch.equal(codes, q),
                  f"fake_quant {shape} axis {axis} {xt.dtype} bits {bits}: "
                  "differs from the plain version")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    rows_n = sum(a == -1 for _, _, a in inputs)
    check(launches == {"rows": 3 * rows_n,
                       "cols": 3 * (len(inputs) - rows_n)},
          f"fake_quant launch counts {launches}")
    log(f"fake_quant: the decode cells' {len(inputs)} operands in bf16 (8 "
        f"and 4 bits) and f32 equal the plain version bit for bit, codes "
        f"too; launches {launches}")
    sums = {arch: [0.0, 0.0, 0.0] for arch in FAKE_QUANT_SHAPES}
    for (arch, shape, axis), x in inputs.items():
        t = _time_ms(lambda: Q.fake_quant(x, 8, axis))
        t_plain = _time_ms(lambda: Q._fake_quant_ref(x, 8, axis))
        t_bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        for i, v in enumerate((t, t_plain, t_bound)):
            sums[arch][i] += v
        log(f"fake_quant: {arch} {shape} axis {axis} bf16: kernel "
            f"{t:.6f} ms, plain {t_plain:.6f} ms, bound {t_bound:.6f} ms "
            f"(bytes)")
    for arch, (t, t_plain, t_bound) in sums.items():
        log(f"fake_quant: {arch}'s operands: kernel {t:.6f} ms, plain "
            f"{t_plain:.6f} ms, bound {t_bound:.6f} ms")
    card, plain, bound = sums["granite-moe-3b-a800m"]
    return [{"name": "fake_quant", "route": "cuda",
             "source": "src/repro_torch/csrc/fake_quant.cu",
             "replaces": "none (XLA fuses src/repro/quant/quantizers.py)",
             "launches": 0, "max_abs_err": 0.0, "ms": card,
             "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
             "library_ms": None}]


#: The MoE slot assignment's shapes (G, S, E, k, C): granite-moe-3b-
#: a800m's decode at batch 1,024 (4 groups of 256 tokens) and its in-window
#: prefill of 1,024 x 64 tokens (256 groups).
MOE_DISPATCH_SHAPES = {"decode": (4, 256, 40, 8, 64),
                       "prefill": (256, 256, 40, 8, 64)}


def phase_moe_dispatch() -> list[dict]:
    """The MoE slot-assignment kernel at granite's decode and prefill
    shapes: dispatch, combine and held bit for bit the plain loop's on the
    CPU, and the seam's three outputs (the load-balance loss too) the
    loop's on the card; then its time beside the loop's on the card (CUDA
    events), the host's time to issue each (no sync), and the bytes bound
    (choices read once, outputs written once).  The row's times are the
    decode shape's; its launches are the model phase's (:func:`main`
    fills them in)."""
    import torch

    import repro_torch.models.moe as moe
    from repro_torch.kernels.moe_dispatch import LAUNCHES, moe_dispatch_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for what, (gc, s, e, k, cap) in MOE_DISPATCH_SHAPES.items():
        gates = torch.softmax(2.0 * torch.randn((gc, s, e), generator=g,
                                                device="cuda"), dim=-1)
        topv, topi = moe._top_k(gates, k)
        LAUNCHES["dispatch"] = 0
        d, c, held = moe_dispatch_cuda(topv, topi, e, cap)
        torch.cuda.synchronize()
        check(LAUNCHES["dispatch"] == 1, f"moe_dispatch {what}: launches "
              f"{LAUNCHES}")
        want_d, want_c = moe._slots_ref(topv.cpu(), topi.cpu(), e, cap)
        check(torch.equal(d.cpu(), want_d)
              and torch.equal(c.cpu().view(torch.int32),
                              want_c.view(torch.int32))
              and torch.equal(held.cpu(), want_d.any(-1).float()),
              f"moe_dispatch {what} {(gc, s, e, k, cap)}: differs from the "
              "plain loop")
        got = moe._top_k_dispatch(gates, k, cap)
        orig = moe._takes_kernel
        moe._takes_kernel = lambda gates: False
        try:
            want = moe._top_k_dispatch(gates, k, cap)
        finally:
            moe._takes_kernel = orig
        check(torch.equal(got[0], want[0])
              and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got[1:], want[1:])),
              f"moe_dispatch {what}: the seam's kernel route differs from "
              "its loop on the card")
        t = _time_ms(lambda: moe_dispatch_cuda(topv, topi, e, cap))
        t_plain = _time_ms(lambda: moe._slots_ref(topv, topi, e, cap))
        host = {}
        for name, fn in (("kernel", lambda: moe_dispatch_cuda(
                topv, topi, e, cap)), ("loop", lambda: moe._slots_ref(
                    topv, topi, e, cap))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            host[name] = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
        nbytes = gc * s * (k * 12 + e * 4 + e * cap * 5)
        t_bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[what] = (t, t_plain, t_bound)
        log(f"moe_dispatch: granite {what} {(gc, s, e, k, cap)}: equal to "
            f"the plain loop bit for bit ({int(d.sum())} of {gc * s * k} "
            f"choices kept); kernel {t:.6f} ms, loop {t_plain:.6f} ms, "
            f"bound {t_bound:.6f} ms (bytes); host to issue: kernel "
            f"{host['kernel']:.6f} ms, loop {host['loop']:.6f} ms")
    card, plain, bound = rows["decode"]
    return [{"name": "moe_dispatch", "route": "cuda",
             "source": "src/repro_torch/csrc/moe_dispatch.cu",
             "replaces": "none (XLA fuses src/repro/models/moe.py:"
                         "_top_k_dispatch)",
             "launches": 0, "max_abs_err": 0.0, "ms": card,
             "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
             "library_ms": None}]


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
    return _result_texts([a]) == _result_texts([b])


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
# (tests/test_torch_models.py holds them equal).  An entry of MODEL_PORTS is
# a benchmark configuration's ``port`` block (``perfbench.run
# .build_config``), not a config of the zoo: ``rwkv6-7b.finch`` is the
# ``rwkv6-7b.decode`` cell's Finch 7B as published (family ``finch``),
# whose parameter count is the configuration file's.
MODEL_ARCHS = ("qwen3-4b", "granite-moe-3b-a800m", "rwkv6-7b",
               "rwkv6-7b.finch", "zamba2-1.2b")
MODEL_PORTS = {"rwkv6-7b.finch": "perfbench/configs/rwkv6-7b.json"}
MODEL_BATCH, MODEL_PROMPT = 4, 64
MODEL_DECODE = {"qwen3-4b": 32, "granite-moe-3b-a800m": 8, "rwkv6-7b": 8,
                "rwkv6-7b.finch": 8, "zamba2-1.2b": 8}
MODEL_PARAMS = {"qwen3-4b": 4_411_424_256,
                "granite-moe-3b-a800m": 3_298_985_472,
                "rwkv6-7b": 7_534_546_944, "rwkv6-7b.finch": 7_635_746_816,
                "zamba2-1.2b": 1_170_313_344}
# Tolerances of the model phase, as shares of the reference logits' largest
# magnitude.  A bfloat16 path rounds to 8 bits of mantissa after every op
# and through 36 layers of fake-quant; a float32 path without fake-quant
# differs only by the order of float32 sums (TF32 off).  Wherever every
# logit moves by at most d, a row's argmax can change only if its top two
# differ by at most 2 d: rows with a wider gap must keep their argmax, and
# the others are ties within the two paths' rounding, printed.
BF16_TOL_FRAC = 0.1
F32_TOL_FRAC = 1e-4
# Fake-quant calls in one decode step of each model at its full config, by
# the kernel's route: rows (activations, per token) and cols (weights, per
# output column).  A dense layer's linear makes one of each; granite's MoE
# layer adds its experts' three weights and their input; zamba2's shared
# attention block runs every 6 of its 38 Mamba2 layers; both RWKV6 blocks
# have eight linears (Finch's LoRAs are not fake-quantised), 16 x 32 calls.
MODEL_FAKE_QUANTS = {"qwen3-4b": {"rows": 252, "cols": 252},
                     "granite-moe-3b-a800m": {"rows": 160, "cols": 224},
                     "rwkv6-7b": {"rows": 256, "cols": 256},
                     "rwkv6-7b.finch": {"rows": 256, "cols": 256},
                     "zamba2-1.2b": {"rows": 125, "cols": 125}}
# A reference MoE gate pair within EXPERT_TIE is a near-tie: card and CPU
# may route it either way.
EXPERT_TIE = 1e-6


def _model_config(arch: str):
    """The ``ArchConfig`` of an entry of MODEL_ARCHS: the zoo's config of
    that name, or the ``port`` block of its MODEL_PORTS file."""
    from repro_torch.configs import get_config

    if arch not in MODEL_PORTS:
        return get_config(arch)
    from perfbench.run import build_config

    return build_config(json.loads((ROOT / MODEL_PORTS[arch]).read_text()))


def _launch(launcher: str, args: list[str], ranks: int = 1,
            group: bool = False) -> list[str]:
    """``python -m repro_torch.launch.<launcher>`` on the card in a
    subprocess, under ``torch.distributed.run`` with ``ranks`` processes
    when there are several or ``group`` asks for one; its output lines."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = [] if ranks == 1 and not group else [
        "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
        str(ranks)]
    proc = subprocess.run([sys.executable] + run + [
                           "-m", f"repro_torch.launch.{launcher}"] + args,
                          capture_output=True, text=True, timeout=900,
                          cwd=ROOT, env=env)
    check(proc.returncode == 0, f"launch.{launcher} failed: "
          f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
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


def _in_forward() -> bool:
    """Whether autograd is not running a backward pass: the calls a
    rematerialised block repeats inside the backward pass are left out of
    the recordings below."""
    import torch

    return torch._C._current_graph_task_id() == -1


@contextlib.contextmanager
def _recording_codes(codes: list):
    """A context in which every fake-quant of a forward pass appends its
    int8 codes (on the host) to ``codes``: ``quantize_int``'s on the CPU,
    the kernel's on the card."""
    import repro_torch.quant.quantizers as Q
    from repro_torch.kernels.fake_quant import fake_quant_cuda

    orig, orig_kernel = Q.quantize_int, Q._fake_quant_kernel

    def rec(*a, **k):
        q, s = orig(*a, **k)
        if _in_forward():
            codes.append(q.cpu())
        return q, s

    def rec_kernel(x, bits, axis):
        out, q = fake_quant_cuda(x, bits, axis, codes=True)
        if _in_forward():
            codes.append(q.cpu())
        return out

    Q.quantize_int, Q._fake_quant_kernel = rec, rec_kernel
    try:
        yield
    finally:
        Q.quantize_int, Q._fake_quant_kernel = orig, orig_kernel


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
    """A context in which every MoE dispatch of a forward pass appends
    (gates, the experts chosen), on the host, to ``choices``."""
    import repro_torch.models.moe as moe

    orig = moe._top_k

    def rec(gates, k):
        v, i = orig(gates, k)
        if _in_forward():
            choices.append((gates.detach().cpu(), i.cpu()))
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


def _sample_tokens(lines: list[str]) -> list[int]:
    """The token ids of a serve launch's ``sample:`` line (numpy may wrap
    it over several lines)."""
    i = next(i for i, ln in enumerate(lines) if ln.startswith("sample:"))
    text = lines[i].removeprefix("sample:")
    while "]" not in text:
        i += 1
        text += " " + lines[i]
    return [int(x) for x in text.strip(" []").split()]


def _serve_model(arch: str, card: str, work: Path, artifact: Path,
                 pick: str | None = None) -> tuple[list[int], dict]:
    """One model of MODEL_ARCHS on the card (module doc, phase 10): at full
    width through prefill and greedy decode, decode after a prefill held
    against the longer prefill at full width in float32 (not for MoE), the
    card against the CPU at 2 full-width layers in float32, and the
    launcher on the frontier store ``work`` (not for a MODEL_PORTS entry:
    the launcher builds the zoo's config).  qwen3-4b (``pick``: the
    service phase's macro) adds the cache check in its bf16 config, the
    card against the CPU with fake-quant on, and a cold launch with the
    profile phase's ``artifact`` before the warm one.  Returns the warm
    launch's sample tokens (row 0's first 16) and the fake-quant kernel's
    launches in the full-width decode steps, by route, beside the MoE
    slot-assignment kernel's (``moe_dispatch``: one per MoE layer a
    step)."""
    import torch

    from repro_torch.core import gemm_inventory
    from repro_torch.kernels.fake_quant import LAUNCHES as FQ_LAUNCHES
    from repro_torch.kernels.moe_dispatch import LAUNCHES as MD_LAUNCHES
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
    cfg = _model_config(arch)
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
    for key in FQ_LAUNCHES:
        FQ_LAUNCHES[key] = 0
    MD_LAUNCHES["dispatch"] = 0
    t0 = time.perf_counter()
    for _ in range(n_decode):
        logits, state = decode(model, state, tok)
        tok = greedy_argmax(logits)
        out.append(tok)
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    fq = dict(FQ_LAUNCHES)
    check(fq == {k: v * n_decode for k, v in MODEL_FAKE_QUANTS[arch].items()},
          f"model: {arch}: fake_quant launches {fq} in {n_decode} decode "
          f"steps, against {MODEL_FAKE_QUANTS[arch]} a step")
    md = MD_LAUNCHES["dispatch"]
    md_step = cfg.n_layers if cfg.moe else 0
    check(md == md_step * n_decode, f"model: {arch}: moe_dispatch launches "
          f"{md} in {n_decode} decode steps, against {md_step} a step")
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
        f"init); fake_quant launches {fq} ({MODEL_FAKE_QUANTS[arch]} a "
        f"step); moe_dispatch launches {md} ({md_step} a step)")
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
    if cfg.family in ("ssm", "finch", "hybrid"):
        # a chunk of 256 tokens: the reference's chunked scan may leave
        # float32 there (ROADMAP.md, "Reference state"); printed, not gated,
        # but for Finch, whose configured chunk keeps the decay finite
        long = torch.as_tensor(rng.integers(0, cfg.vocab, (MODEL_BATCH, 256)),
                               device="cuda")
        lg, _ = api.prefill(model, long, 256)
        bad = (~torch.isfinite(lg[..., :cfg.vocab])).any(-1).any(0)
        log(f"model: {arch}: prefill of {MODEL_BATCH}x256 tokens in the "
            f"config: finite {not bool(bad.any())}; {int(bad.sum())} of "
            f"256 positions with a non-finite logit")
        check(cfg.family != "finch" or not bool(bad.any()),
              f"model: {arch}: a 256-token prefill at chunk "
              f"{cfg.ssm.chunk} is not finite")
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
    if arch in MODEL_PORTS:
        log(f"model: {arch} in all {time.perf_counter() - t_arch:.3f} s")
        return [], {**fq, "moe_dispatch": md}

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
        lines = _launch("serve", args)
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
    return _sample_tokens(lines), {**fq, "moe_dispatch": md}


def phase_model(pick: str, artifact: Path) -> tuple[list[int], dict]:
    """The port's model zoo on the card (module doc, phase 10): each of
    MODEL_ARCHS in turn, qwen3-4b first, through :func:`_serve_model` on
    one frontier store.  Returns qwen3-4b's launch's sample tokens and the
    fake-quant kernel's launches in the models' decode steps (``rows``,
    ``cols``) beside the MoE slot-assignment kernel's (``moe_dispatch``)."""
    import shutil

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"model: {card}")
    work = ROOT / "build" / "model"
    shutil.rmtree(work, ignore_errors=True)
    runs = {arch: _serve_model(arch, card, work / "cache", artifact,
                               pick if arch == "qwen3-4b" else None)
            for arch in MODEL_ARCHS}
    launches = {k: sum(run[1][k] for run in runs.values())
                for k in ("rows", "cols", "moe_dispatch")}
    return runs["qwen3-4b"][0], launches


# ---------------------------------------------------------------------------
# 11. train
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("qwen3-4b", "llama3.2-3b", "phi3-mini-3.8b",
               "mistral-large-123b", "internvl2-1b", "whisper-tiny",
               "granite-moe-1b-a400m", "granite-moe-3b-a800m", "rwkv6-7b",
               "zamba2-1.2b")
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, TRAIN_SMOKE_LR = 8, 16, 1e-3
# card against CPU, one train step at a smoke config (the tolerances of
# tests/test_torch_train.py): without a code or expert flip, loss, ce,
# aux and grad norm within TRAIN_LOSS relative, each moment within
# TRAIN_LEAF of its largest magnitude, each parameter within TRAIN_LEAF of
# its leaf's largest magnitude plus TRAIN_LR_FRAC learning rates, or two
# where the CPU's clipped gradient is below TRAIN_SMALL_GRAD of its leaf's
# largest (AdamW's first step g / (|g| + eps) turns a gradient near eps or
# under the summation noise into a step anywhere in (-1, 1)); with a flip,
# within TRAIN_FLIP_LOSS and TRAIN_FLIP_MOMENT, and each parameter within
# TRAIN_FLIP_PARAM of its leaf's largest magnitude plus TRAIN_LR_FRAC
# learning rates, or two where the gradient is below TRAIN_FLIP_MOMENT of
# the leaf's largest (the flip moves gradients by that much)
TRAIN_LOSS, TRAIN_LEAF, TRAIN_LR_FRAC = 1e-5, 1e-4, 0.1
TRAIN_SMALL_GRAD = 1e-3
TRAIN_FLIP_LOSS, TRAIN_FLIP_PARAM, TRAIN_FLIP_MOMENT = 1e-3, 0.01, 0.05
# full width: llama3.2-3b, 6 steps of 4 x 512 tokens in 2 microbatches
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = (
    "llama3.2-3b", 6, 4, 512, 2)
BF16_FLOPS_PER_S = 989e12


def _train_step_on(arch: str, device: str, model_state: dict, batch):
    """One ``make_train_step`` step of ``arch``'s smoke config on
    ``device`` from ``model_state``; returns (metrics as floats, the
    parameters and moments on the host, int8 codes, expert choices)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model, model_class
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.train import make_train_step

    cfg = smoke_config(arch)
    api = get_model(cfg)
    model = model_class(cfg)(cfg, device=device)
    model.load_state_dict(model_state)
    opt = adamw_init(dict(model.named_parameters()))
    codes, choices = [], []
    with _recording_codes(codes), _recording_experts(choices):
        model, opt, m = make_train_step(api, constant_lr(TRAIN_SMOKE_LR))(
            model, opt, batch)
    host = {"p": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "m": {n: t.cpu() for n, t in opt["m"].items()},
            "v": {n: t.cpu() for n, t in opt["v"].items()}}
    return {k: float(v) for k, v in m.items()}, host, codes, choices


def _train_smoke(arch: str) -> None:
    """(a): one train step of ``arch``'s smoke config on the card against
    the CPU from the same parameters and batch."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import get_model

    cfg = smoke_config(arch)
    fr = cfg.frontend
    batch = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SMOKE_SEQ,
        global_batch=TRAIN_SMOKE_BATCH,
        frontend_tokens=fr.n_tokens if fr else 0,
        frontend_dim=fr.d_frontend if fr else 0)).batch(0)
    state = get_model(cfg).init_params(torch.Generator().manual_seed(SEED),
                                       device="cpu").state_dict()
    card, got, gcodes, gchoices = _train_step_on(arch, "cuda", state, batch)
    cpu, want, wcodes, wchoices = _train_step_on(arch, "cpu", state, batch)
    flip = _first_flip(gcodes, wcodes) or _first_expert_flip(gchoices,
                                                             wchoices)
    worst = {}
    for kind in ("p", "m", "v"):
        for name, w in want[kind].items():
            diff = (got[kind][name] - w).abs()
            scale = w.abs().max().item()
            leaf, small = ((TRAIN_FLIP_PARAM, TRAIN_FLIP_MOMENT)
                           if flip is not None else
                           (TRAIN_LEAF, TRAIN_SMALL_GRAD))
            if kind == "p":
                g = (want["v"][name] / (1 - 0.95)).sqrt()
                bound = leaf * scale + TRAIN_SMOKE_LR * torch.where(
                    g < small * g.max(), 2.0, TRAIN_LR_FRAC)
            else:
                bound = (TRAIN_FLIP_MOMENT if flip is not None
                         else TRAIN_LEAF) * scale
            check(bool((diff <= bound).all()), f"train: {arch}: {kind} "
                  f"{name} on the card differs from the CPU by "
                  f"{diff.max().item():.3g}")
            worst[kind] = max(worst.get(kind, 0.0),
                              diff.max().item() / max(scale, 1e-30))
    tol = TRAIN_LOSS if flip is None else TRAIN_FLIP_LOSS
    for key in ("loss", "ce", "grad_norm", "lr"):
        rel = abs(card[key] - cpu[key]) / max(abs(cpu[key]), 1e-30)
        check(rel <= tol, f"train: {arch}: {key} {card[key]!r} on the card, "
              f"{cpu[key]!r} on the CPU")
    check(abs(card["aux"] - cpu["aux"]) <= tol * max(abs(cpu["aux"]), 1.0),
          f"train: {arch}: aux {card['aux']!r} / {cpu['aux']!r}")
    log(f"train: {arch} smoke, one step of {TRAIN_SMOKE_BATCH}x"
        f"{TRAIN_SMOKE_SEQ} tokens, card against CPU: loss {card['loss']!r} "
        f"/ {cpu['loss']!r}, grad norm {card['grad_norm']!r} / "
        f"{cpu['grad_norm']!r}; flip {flip} ({len(wcodes)} quantizer calls, "
        f"{len(wchoices)} MoE dispatches); worst |diff| / max: params "
        f"{worst['p']:.3g}, m {worst['m']:.3g}, v {worst['v']:.3g}")


def _train_full_width(card: str, work: Path) -> dict:
    """(b): llama3.2-3b at full width through the launcher (gated on its
    printed losses), then the same run in this process, timed and traced.
    Returns step 0's loss (``loss0``), the peak device memory (``peak``,
    and ``held`` before the run), the mean ms per step and the traced
    step's busy share."""
    import math
    import re

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, linear_warmup_cosine
    from repro_torch.train import init_train_state, make_train_step

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
            str(TRAIN_MICRO), "--save-every", "1000"]
    t0 = time.perf_counter()
    lines = _launch("train", argv + ["--ckpt-dir", str(work / "ckpt")])
    wall = time.perf_counter() - t0
    for line in lines:
        log(f"  {line}")
    printed = {int(m[1]): (float(m[2]), float(m[3])) for m in
               (re.match(r"step +(\d+) loss=(\S+) gnorm=(\S+)", ln)
                for ln in lines) if m}
    check(sorted(printed) == [0, TRAIN_STEPS - 1]
          and all(math.isfinite(x) for v in printed.values() for x in v)
          and printed[TRAIN_STEPS - 1][0] < printed[0][0]
          and lines[-1].startswith(f"trained {TRAIN_STEPS} steps"),
          f"train: the launcher's losses: {printed}")
    log(f"train: launch.train {TRAIN_ARCH} full width, {TRAIN_STEPS} steps: "
        f"{wall:.3f} s with start-up")

    cfg = get_config(TRAIN_ARCH)
    api = get_model(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, opt = init_train_state(api, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(len(model.blocks) == cfg.n_layers,
          f"train: {len(model.blocks)} layers")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    lr = linear_warmup_cosine(3e-4, warmup=min(20, TRAIN_STEPS // 5),
                              total_steps=TRAIN_STEPS)
    step = make_train_step(api, lr, AdamWConfig(), microbatches=TRAIN_MICRO)
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, corpus.batch(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + norms)
          and losses[-1] < losses[0],
          f"train: full width: losses {losses}, grad norms {norms}")
    check(f"{losses[0]:.4f}" == f"{printed[0][0]:.4f}",
          f"train: step 0's loss {losses[0]!r} in process, "
          f"{printed[0][0]!r} from the launcher")
    wall1, busy, kernels = _device_profile(
        lambda: step(model, opt, corpus.batch(TRAIN_STEPS)))
    ms = [t * 1e3 for t in times[1:]]
    mean_ms = sum(ms) / len(ms)
    flops6 = 6 * n_params * tokens
    adam_bytes = 22 * n_params
    bound6 = flops6 / BF16_FLOPS_PER_S * 1e3
    bound8 = 8 * n_params * tokens / BF16_FLOPS_PER_S * 1e3
    adam_ms = adam_bytes / HBM_BYTES_PER_S * 1e3
    log(f"train: {TRAIN_ARCH} full width on {card}: {cfg.n_layers} layers, "
        f"{n_params} parameters ({cfg.param_dtype}), drawn in {t_init:.3f} "
        f"s; {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} = {tokens} "
        f"tokens in {TRAIN_MICRO} microbatches")
    log(f"train: losses {losses}; grad norms {norms}")
    log(f"train: ms per step, steps 1-{TRAIN_STEPS - 1}: "
        f"{[round(x, 3) for x in ms]}; mean {mean_ms:.3f} ms, "
        f"{tokens / (mean_ms * 1e-3):.1f} tokens/s (step 0 "
        f"{times[0] * 1e3:.3f} ms)")
    log(f"train: peak device memory {peak} bytes ({held} held before "
        f"init); one traced step {wall1 * 1e3:.3f} ms, device busy "
        f"{busy * 1e3:.3f} ms in {kernels} kernels: {busy / wall1:.1%} of "
        f"the traced step, {busy * 1e3 / mean_ms:.1%} of the mean untraced "
        f"step")
    log(f"train: bound per step max(6 N T / 989 TFLOP/s = {bound6:.3f} ms "
        f"[8 N T with remat's extra forward: {bound8:.3f} ms], AdamW's "
        f"{adam_bytes} state bytes / 3.35 TB/s = {adam_ms:.3f} ms) = "
        f"{max(bound6, adam_ms):.3f} ms; the mean step is "
        f"{mean_ms / max(bound6, adam_ms):.1f}x it")
    del model, opt, m, step
    torch.cuda.empty_cache()
    return {"loss0": losses[0], "peak": peak, "held": held,
            "ms": mean_ms, "busy": busy / wall1}


def _train_drill() -> None:
    """(c): the restart drill on the card, deterministic, as a
    subprocess."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_fault_tolerance_drill.py"),
         "--deterministic"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"  {line}")
    check(proc.returncode == 0 and lines[-1:] == [
        "exactly-once restart semantics: PASS"],
          f"train: the restart drill failed: {proc.stdout[-2000:]}"
          f"{proc.stderr[-3000:]}")
    log(f"train: restart drill on the card (failures at steps 7 and 13, "
        f"torch.use_deterministic_algorithms): the final parameters and "
        f"moments equal the failure-free run's; "
        f"{time.perf_counter() - t0:.3f} s")


def phase_train() -> dict:
    """The training path on the card (module doc, phase 11); returns what
    the full-width run measured (:func:`_train_full_width`)."""
    import shutil

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"train: {card}")
    work = ROOT / "build" / "train"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    for arch in TRAIN_ARCHS:
        _train_smoke(arch)
    log(f"train: ten smoke configs, card against CPU: "
        f"{time.perf_counter() - t0:.3f} s")
    measured = _train_full_width(card, work)
    _train_drill()
    return measured


# ---------------------------------------------------------------------------
# 12. scale
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one card, and this run has one: every group of
# ranks here is gloo, each rank's tensors on cuda:0.
SCALE_BACKEND = "gloo"
SCALE_RANKS = 4
# (b) llama3.2-3b at full width on a 2x2 mesh of 4 ranks, the train
# phase's batch; step 0's loss within SCALE_LOSS (relative) of the train
# phase's.  The launcher prints 4 decimals: up to 4.1e-6 of rounding at a
# loss near 12.3, so the limit leaves the sharded sum about 6e-6.
SCALE_MESH, SCALE_STEPS, SCALE_LOSS = "2x2", 2, 1e-5
# (d) the elastic drill at the smoke config; its sharded losses against one
# device's, relative: the sharded step's tolerance in the tests, and the
# tolerance of a loss from a step on which a fake-quant code flipped
SCALE_ELASTIC_ARCH, SCALE_ELASTIC_BATCH, SCALE_ELASTIC_SEQ = (
    "llama3.2-3b", 8, 32)
SCALE_STEP_LOSS, SCALE_FLIP_LOSS = 1e-4, 1e-3
# (e) qwen3-4b at full width on a 2x1 mesh of 2 ranks
SCALE_SERVE_MESH, SCALE_SERVE_RANKS, SCALE_SERVE_DECODE = "2x1", 2, 8


def _flat_leaves(tree) -> list:
    """A checkpoint tree's leaves as bytes, in the checkpoint's order."""
    from repro_torch.ckpt.manager import _flatten, _host_leaf

    return [_host_leaf(x).array.tobytes() for x in _flatten(tree)]


def _elastic_state(mesh, tree=None):
    """The smoke config's train state on ``mesh`` (None: one device): the
    seeded draw, or ``tree`` placed on it; its step and train step."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models import get_model
    from repro_torch.optim import constant_lr
    from repro_torch.train import init_train_state, make_train_step

    cfg = smoke_config(SCALE_ELASTIC_ARCH)
    api = get_model(cfg)
    if tree is None:
        model, opt = init_train_state(api, device="cuda", mesh=mesh)
    else:
        model, opt = train_state_from_numpy(cfg, tree, device="cuda",
                                            mesh=mesh)
    return cfg, model, opt, make_train_step(api, constant_lr(3e-3),
                                            mesh=mesh)


def _elastic_steps(model, opt, train, cfg, steps) -> tuple:
    """The drill's train steps ``steps`` from (model, opt): the new state,
    each step's loss and the hashes of each step's fake-quant code rows
    (the last-axis rows of every code array of its forward passes: a
    rank's rows are rows of the one-device step's where no code flips)."""
    import hashlib

    losses, rows = [], []
    for i in steps:
        codes = []
        with _recording_codes(codes):
            model, opt, m = train(model, opt, _elastic_batch(cfg, i))
        losses.append(float(m["loss"]))
        rows.append(sorted({
            hashlib.blake2b(r.tobytes(), digest_size=8).hexdigest()
            for q in codes for r in q.reshape(-1, q.shape[-1]).numpy()}))
    return model, opt, losses, rows


def _elastic_batch(cfg, i: int) -> dict:
    from repro_torch.data import DataConfig, SyntheticCorpus

    return SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=SCALE_ELASTIC_SEQ,
        global_batch=SCALE_ELASTIC_BATCH)).batch(i)


def _elastic_restore(work: Path, mesh) -> dict:
    """Restore the drill's checkpoint onto ``mesh``: whether every leaf
    gathered back equals the file's bit for bit, and the next step's
    loss."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import smoke_config
    from repro_torch.convert import train_state_layout, train_state_to_numpy

    layout = train_state_layout(smoke_config(SCALE_ELASTIC_ARCH))
    tree, step = load_checkpoint(work / "ckpt", layout)
    cfg, model, opt, train = _elastic_state(mesh, tree)
    back = train_state_to_numpy(cfg, model, opt)
    same = _flat_leaves(back) == _flat_leaves(tree)
    _, _, m = train(model, opt, _elastic_batch(cfg, step))
    return {"same": same, "step": step, "loss": float(m["loss"]),
            "leaves": len(_flat_leaves(tree))}


def _scale_drill(rank: int, world: int, work: str, what: str):
    """One drill of the scale phase on this rank; its result."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives as C

    res = None
    if what == "probe":
        res = C.probe("cuda")
    elif what == "compress":
        from repro_torch.optim import (compressed_all_reduce_tree,
                                       ef_state_init)
        mesh = make_host_mesh((2, world // 2), ("pod", "data"))
        pod = mesh.get_local_rank(0)
        g = np.random.default_rng(SEED).normal(size=(8, 64)) * 0.01
        res = {}
        for dev in ("cuda", "cpu"):
            grads = {"w": torch.tensor(g[4 * pod:4 * pod + 4],
                                       dtype=torch.float32, device=dev)}
            err = ef_state_init(grads)
            out = []
            for _ in range(2):         # the second round carries err
                mean, err = compressed_all_reduce_tree(
                    grads, err, mesh.get_group("pod"))
                out += [mean["w"].cpu().numpy().tobytes().hex(),
                        err["w"].cpu().numpy().tobytes().hex()]
            res[dev] = out
        every = [None] * world
        dist.all_gather_object(every, res)
        res = every
    elif what == "elastic_save":
        from repro_torch.ckpt import save_checkpoint
        from repro_torch.convert import train_state_to_numpy

        mesh = make_host_mesh((2, world // 2))
        cfg, model, opt, train = _elastic_state(mesh)
        model, opt, losses, rows = _elastic_steps(model, opt, train, cfg,
                                                  range(2))
        state = train_state_to_numpy(cfg, model, opt)
        _, _, nxt, nrows = _elastic_steps(model, opt, train, cfg, [2])
        if rank == 0:
            save_checkpoint(Path(work) / "ckpt", 2, state)
        every = [None] * world
        dist.all_gather_object(every, rows + nrows)
        res = {"losses": losses, "next": nxt[0], "rows": every}
    elif what == "elastic_restore":
        res = _elastic_restore(Path(work), make_host_mesh((world, 1)))
    return res


def _scale_rank(rank: int, world: int, work: str, whats: list[str]) -> None:
    """One rank of a group of the scale phase on the card (gloo,
    ``file://`` init in ``work``), running each drill of ``whats`` in
    turn; rank 0 writes each result to ``work/<what>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(SCALE_BACKEND,
                            init_method=f"file://{work}/init_{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        for what in whats:
            res = _scale_drill(rank, world, work, what)
            if rank == 0:
                Path(work, f"{what}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _on_ranks(whats: list[str], world: int, work: Path) -> dict:
    """Run the drills ``whats`` in one group of ``world`` ranks; their
    results by name."""
    import torch.multiprocessing as mp

    mp.spawn(_scale_rank, args=(world, str(work), whats), nprocs=world,
             join=True)
    return {w: json.loads((work / f"{w}.json").read_text()) for w in whats}


def phase_scale(train_loss0: float, serve_sample: list[int]) -> dict:
    """Scale-out on the card (module doc, phase 12): several ranks on the
    one card in gloo groups.  Returns what the 2x2 run's ``mesh:`` line
    printed: each rank's peak device memory (``peaks``) and collective
    bytes per step (``bytes``), and the ms per step (``ms``)."""
    import math
    import re
    import shutil

    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"scale: {card}; backend {SCALE_BACKEND}: NCCL refuses two ranks "
        f"on one card, and this run has one card, so every group of two or "
        f"more ranks here is gloo with each rank's tensors on cuda:0; (f) "
        f"opens the launchers' default NCCL group on one rank")
    work = ROOT / "build" / "scale"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.empty_cache()
    log(f"scale: this process holds {torch.cuda.memory_allocated()} bytes "
        f"on the card ({torch.cuda.memory_reserved()} reserved) after the "
        f"earlier phases")

    # -- (a), (c) and (d)'s save: one group of 4 ranks ----------------------
    t0 = time.perf_counter()
    drills = _on_ranks(["probe", "compress", "elastic_save"], SCALE_RANKS,
                       work)
    t_drills = time.perf_counter() - t0
    probe, comp, saved = (drills["probe"], drills["compress"],
                          drills["elastic_save"])

    # -- (a) which collectives gloo runs on CUDA tensors --------------------
    for op, by_dtype in probe.items():
        log(f"scale: gloo on cuda, {SCALE_RANKS} ranks: {op}: {by_dtype}")
    check(all(v == "ok" for d in probe.values() for v in d.values()),
          f"scale: a collective fails on CUDA tensors under gloo: {probe}")
    log(f"scale: every collective of the scale-out path runs on CUDA "
        f"tensors under gloo; none is staged through host memory by the "
        f"port (the group of {SCALE_RANKS} ranks for (a), (c) and (d)'s "
        f"save: {t_drills:.3f} s)")

    # -- (b) llama3.2-3b at full width on a 2x2 mesh of 4 ranks -------------
    t0 = time.perf_counter()
    lines = _launch("train", [
        "--arch", TRAIN_ARCH, "--mesh", SCALE_MESH, "--backend",
        SCALE_BACKEND, "--steps", str(SCALE_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
        str(TRAIN_MICRO), "--save-every", "1000", "--ckpt-dir",
        str(work / "train")], ranks=SCALE_RANKS)
    wall = time.perf_counter() - t0
    for line in lines:
        log(f"  {line}")
    printed = {int(m[1]): float(m[2]) for m in
               (re.match(r"step +(\d+) loss=(\S+)", ln) for ln in lines)
               if m}
    check(sorted(printed) == [0, SCALE_STEPS - 1]
          and all(math.isfinite(x) for x in printed.values()),
          f"scale: the 2x2 run's losses: {printed}")
    rel = abs(printed[0] - train_loss0) / abs(train_loss0)
    check(rel <= SCALE_LOSS, f"scale: step 0's loss {printed[0]} on 2x2, "
          f"{train_loss0!r} on one device (rel {rel:.3g})")
    share = next(ln for ln in lines if ln.startswith("mesh: ") and
                 "share held per rank" in ln)
    shares = [float(x) for x in
              share.split("share held per rank ")[1].strip("[]").split(",")]
    check(len(shares) == SCALE_RANKS and all(x == 0.25 for x in shares),
          f"scale: the leaves sharded over both axes: {share}")
    meshline = next(ln for ln in lines if ln.startswith("mesh: ms per step"))
    lists = [json.loads(m) for m in re.findall(r"\[[^\]]*\]", meshline)]
    mesh_run = {"ms": lists[0], "peaks": lists[1], "bytes": lists[2]}
    check(len(mesh_run["peaks"]) == len(mesh_run["bytes"]) == SCALE_RANKS,
          f"scale: the 2x2 run's mesh line: {meshline}")
    log(f"scale: launch.train {TRAIN_ARCH} full width on a {SCALE_MESH} "
        f"mesh of {SCALE_RANKS} ranks on {card}: step 0's loss "
        f"{printed[0]} against the one-device {train_loss0!r} (rel "
        f"{rel:.3g} <= {SCALE_LOSS}); each rank holds a quarter of every "
        f"leaf sharded over both axes; {wall:.3f} s with start-up")

    # -- (c) compression: 4 ranks on CUDA tensors == on CPU tensors ---------
    check(all(r["cuda"] == r["cpu"] for r in comp),
          "scale: compressed_all_reduce_tree on CUDA tensors differs from "
          "the CPU's")
    log(f"scale: compressed_all_reduce_tree over the pod group of a (2, 2) "
        f"('pod', 'data') mesh, N(0, 0.01) gradients from default_rng(0), "
        f"two rounds with error feedback: every rank's mean and error on "
        f"the card equal the CPU's bit for bit")

    # -- (d) elastic: save on 2x2, resume on 2x1 and 1x1 --------------------
    t0 = time.perf_counter()
    cfg, model, opt, train = _elastic_state(None)
    _, _, want, want_rows = _elastic_steps(model, opt, train, cfg, range(3))
    del model, opt
    got = saved["losses"] + [saved["next"]]
    flip = next((i for i, w in enumerate(want_rows)
                 if any(not set(r[i]) <= set(w) for r in saved["rows"])),
                None)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = SCALE_STEP_LOSS if flip is None or i < flip else \
            SCALE_FLIP_LOSS
        check(abs(g - w) <= tol * abs(w),
              f"scale: elastic drill step {i}: loss {g!r} on 2x2, {w!r} on "
              f"one device (first code flip at step {flip})")
    log(f"scale: elastic drill, steps 0-2 on 2x2 against one device: "
        f"losses {got} / {want}, rel "
        f"{', '.join(f'{abs(g - w) / abs(w):.3g}' for g, w in zip(got, want))}"
        f" within {SCALE_STEP_LOSS}, or {SCALE_FLIP_LOSS} from the first "
        f"fake-quant code flip (step {flip})")
    two = _on_ranks(["elastic_restore"], 2, work)["elastic_restore"]
    one = _elastic_restore(work, None)
    check(two["same"] and one["same"] and two["step"] == one["step"] == 2,
          f"scale: elastic restore: 2x1 {two}, 1x1 {one}")
    log(f"scale: elastic drill ({SCALE_ELASTIC_ARCH} smoke, batch "
        f"{SCALE_ELASTIC_BATCH}x{SCALE_ELASTIC_SEQ}): 2 steps on 2x2 "
        f"(losses {saved['losses']}), checkpoint of the global arrays; "
        f"restored onto 2x1 and onto one device, all {one['leaves']} "
        f"leaves gathered back equal the file bit for bit; next loss "
        f"{saved['next']!r} on 2x2, {two['loss']!r} on 2x1, "
        f"{one['loss']!r} on one device (the restores: "
        f"{time.perf_counter() - t0:.3f} s)")

    # -- (e) qwen3-4b at full width on a 2x1 mesh of 2 ranks ----------------
    t0 = time.perf_counter()
    lines = _launch("serve", [
        "--arch", "qwen3-4b", "--mesh", SCALE_SERVE_MESH, "--backend",
        SCALE_BACKEND, "--batch", str(MODEL_BATCH), "--prompt-len",
        str(MODEL_PROMPT), "--decode-steps", str(SCALE_SERVE_DECODE)],
        ranks=SCALE_SERVE_RANKS)
    wall = time.perf_counter() - t0
    for line in lines:
        log(f"  {line}")
    got = _sample_tokens(lines)
    want = serve_sample[:SCALE_SERVE_DECODE]
    check(got == want, f"scale: qwen3-4b on {SCALE_SERVE_MESH}: greedy "
          f"tokens {got}, one device {want}")
    log(f"scale: launch.serve qwen3-4b full width on a {SCALE_SERVE_MESH} "
        f"mesh of {SCALE_SERVE_RANKS} ranks, prompts {MODEL_BATCH}x"
        f"{MODEL_PROMPT}, {SCALE_SERVE_DECODE} decode steps: row 0's "
        f"tokens {got} == the model phase's one-device launch; {wall:.3f} s "
        f"with start-up")
    _default_backend_launches(work)
    return mesh_run


def _default_backend_launches(work: Path) -> None:
    """Phase 12 (f): the launchers with their default backend (``nccl``)
    under ``torch.distributed.run`` on one rank, against the same launches
    without a process group; the four launches run at once."""
    import re

    train = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "2",
             "--save-every", "1000"]
    serve = ["--arch", "qwen3-4b", "--smoke"]
    jobs = {(name, group): (lambda name=name, args=args, group=group:
                            _launch(name, args + (
                                ["--ckpt-dir", str(work / f"nccl_{group}")]
                                if name == "train" else []), group=group))
            for name, args in (("train", train), ("serve", serve))
            for group in (True, False)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        out = {key: f.result() for key, f in futures.items()}
    wall = time.perf_counter() - t0
    for (name, group), lines in out.items():
        log(f"  launch.{name} {'one NCCL rank' if group else 'no group'}:")
        for line in lines:
            log(f"    {line}")
    for name in ("train", "serve"):
        backends = [ln for ln in out[name, True] if ln.startswith("group:")]
        check(backends == ["group: backend nccl, world 1"],
              f"scale (f): launch.{name} on one rank reports {backends}, "
              f"want the default backend nccl")
        check(not any(ln.startswith("group:") for ln in out[name, False]),
              f"scale (f): launch.{name} without a group reports one")
    losses = {g: {int(m[1]): float(m[2]) for m in
                  (re.match(r"step +(\d+) loss=(\S+)", ln)
                   for ln in out["train", g]) if m} for g in (True, False)}
    check(sorted(losses[True]) == sorted(losses[False]) == [0, 1]
          and all(abs(losses[True][s] - losses[False][s]) <= 1e-4
                  for s in (0, 1)),
          f"scale (f): launch.train losses on one NCCL rank {losses[True]}, "
          f"without a group {losses[False]}")
    samples = {g: [ln for ln in out["serve", g] if ln.startswith("sample:")]
               for g in (True, False)}
    check(len(samples[True]) == 1 and samples[True] == samples[False],
          f"scale (f): launch.serve samples on one NCCL rank "
          f"{samples[True]}, without a group {samples[False]}")
    log(f"scale (f): launch.train {TRAIN_ARCH} smoke (2 steps) and "
        f"launch.serve qwen3-4b smoke under torch.distributed.run on one "
        f"rank with the default backend: each reports nccl; losses "
        f"{losses[True]} == {losses[False]} without a group (within a unit "
        f"of the last printed digit), {samples[True][0]} == without a "
        f"group; the four launches at once in {wall:.3f} s")


# ---------------------------------------------------------------------------
# 13. dryrun
# ---------------------------------------------------------------------------

# (a) and (b): the dry run's peak memory per rank within DRYRUN_MEM
# (relative) of what the train and scale phases measured on the card
DRYRUN_MEM = 0.10
# (c): one production cell, traced on the card's host
DRYRUN_CELL = ("qwen3-4b", "decode_32k", "single")


def _dryrun_terms(rec: dict) -> str:
    from repro_torch.roofline.report import roofline_terms

    r = roofline_terms(rec)
    return (f"t_compute {r['t_c'] * 1e3:.3f} ms, t_memory "
            f"{r['t_m'] * 1e3:.3f} ms, t_collective {r['t_x'] * 1e3:.3f} ms,"
            f" bound {r['bound_s'] * 1e3:.3f} ms ({r['dom']})")


def phase_dryrun(train: dict, mesh_run: dict) -> None:
    """The dry run against the card (module doc, phase 13)."""
    import os

    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import run_cell

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"dryrun: {card}; every cell is traced on meta tensors in this "
        f"process (rank 0 of a fake process group): nothing runs on the "
        f"card")
    shape = ShapeCfg(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ,
                     TRAIN_BATCH, "train")

    # -- (a) the train phase's one-device cell -----------------------------
    t0 = time.perf_counter()
    one = run_cell(TRAIN_ARCH, shape, (1, 1), microbatches=TRAIN_MICRO)
    t_one = time.perf_counter() - t0
    pred = one["memory"]["total_bytes"]
    got = train["peak"] - train["held"]
    rel = abs(pred - got) / got
    log(f"dryrun: (a) {TRAIN_ARCH} full width on one device, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches: "
        f"predicted peak {pred} bytes ({one['memory']['argument_size_in_bytes']}"
        f" of arguments), measured {got} (max_memory_allocated "
        f"{train['peak']} less {train['held']} held before): rel {rel:.4f}; "
        f"traced in {t_one:.3f} s")
    log(f"dryrun: (a) {_dryrun_terms(one)}; measured on {card}: "
        f"{train['ms']:.3f} ms per step, device busy {train['busy']:.1%} of "
        f"a traced step")
    check(rel <= DRYRUN_MEM, f"dryrun: (a) predicted peak {pred}, measured "
          f"{got} (rel {rel:.4f} > {DRYRUN_MEM})")

    # -- (b) the scale phase's 2x2 cell ------------------------------------
    t0 = time.perf_counter()
    four = run_cell(TRAIN_ARCH, shape, (2, 2), microbatches=TRAIN_MICRO)
    t_four = time.perf_counter() - t0
    handed = four["cost"]["coll_in_bytes_per_device"]
    pred = four["memory"]["total_bytes"]
    rels = [abs(pred - p) / p for p in mesh_run["peaks"]]
    log(f"dryrun: (b) {TRAIN_ARCH} on 2x2: bytes handed to the collectives "
        f"per rank per step {int(handed)}, the launcher's {mesh_run['bytes']};"
        f" predicted peak per rank {pred}, measured {mesh_run['peaks']} (rel "
        f"{[round(r, 4) for r in rels]}); traced in {t_four:.3f} s")
    log(f"dryrun: (b) {_dryrun_terms(four)}; measured ms per step "
        f"{mesh_run['ms']} (gloo through host memory, one card)")
    check(all(b == handed for b in mesh_run["bytes"]),
          f"dryrun: (b) bytes per rank {mesh_run['bytes']}, dry run "
          f"{handed}")
    check(max(rels) <= DRYRUN_MEM, f"dryrun: (b) predicted peak {pred}, "
          f"measured {mesh_run['peaks']}")

    # -- (c) one production cell through the command line ------------------
    arch, shp, mk = DRYRUN_CELL
    out = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shp, "--mesh", mk, "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"dryrun: (c) {DRYRUN_CELL} failed: "
          f"{proc.stderr[-3000:]}")
    rec = json.loads((out / f"{arch}__{shp}__{mk}.json").read_text())
    check(rec.get("ok") is True and rec["devices"] == 256,
          f"dryrun: (c) the record: {rec}")
    log(f"dryrun: (c) {arch} {shp} on the {mk} mesh ({rec['devices']} "
        f"ranks): ok, traced in {rec['trace_s']} s ({wall:.3f} s with "
        f"start-up); record {json.dumps(rec)}")
    log(f"dryrun: (c) {_dryrun_terms(rec)}")


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
    sys.path.append(str(ROOT / "tests"))       # the dominance edge sets
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    phase_device()
    t1 = time.perf_counter()
    chosen = phase_compiler()
    t2 = time.perf_counter()
    compiler_kernels = chosen["kernels"] + phase_shard(chosen)
    t2b = time.perf_counter()
    kernels, wk = phase_mac(chosen["language"])
    kernels = compiler_kernels + kernels
    t3 = time.perf_counter()
    kernels += phase_csa(wk)
    t4 = time.perf_counter()
    kernels += phase_ssm()
    kernels += phase_fake_quant()
    kernels += phase_moe_dispatch()
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
    serve_sample, model_launches = phase_model(pick, artifact)
    fq_launches = {r: model_launches[r] for r in ("rows", "cols")}
    for k in kernels:
        # the model phase's full-width decode steps: the main path
        if k["name"] == "fake_quant":
            k.update(launches=sum(fq_launches.values()),
                     launches_by_route=fq_launches)
        elif k["name"] == "moe_dispatch":
            k.update(launches=model_launches["moe_dispatch"])
    t10 = time.perf_counter()
    train = phase_train()
    t11 = time.perf_counter()
    mesh_run = phase_scale(train["loss0"], serve_sample)
    t12 = time.perf_counter()
    phase_dryrun(train, mesh_run)
    t13 = time.perf_counter()
    log(f"phases: device {t1 - t0:.3f} s, compiler {t2 - t1:.3f} s, "
        f"shard {t2b - t2:.3f} s, mac {t3 - t2b:.3f} s, csa {t4 - t3:.3f} s, "
        f"ssm, fake_quant and moe_dispatch {t5 - t4:.3f} s, autotune {t6 - t5:.3f} s, profile "
        f"{t7 - t6:.3f} s, serving {t8 - t7:.3f} s, service "
        f"{t9 - t8:.3f} s, model {t10 - t9:.3f} s, train "
        f"{t11 - t10:.3f} s, scale {t12 - t11:.3f} s, dryrun "
        f"{t13 - t12:.3f} s")
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
