#!/usr/bin/env python3
"""Probe of the ``dcim_mac`` kernels (``csrc/dcim_mac.cu``) on one card.

    python3 probes/mac_tma.py [--check | --diag | --trace | --variants
                               [--only NAME,...]]

Every mode first prints the card's name and power limit, the toolchain,
each kernel's registers and spill bytes and whether ptxas serialized its
wgmma pipeline, how many clusters of 1, 2, 4 and 8 TMA blocks the card
holds at once at each ring depth (``plan.SLOTS``), and runs every output
kind on both routes, each ring depth and each K split at small shapes
against the plain version (``torch.equal``).  It launches no TMA kernel
unless ptxas gave it the 168 registers a thread its ``setmaxnreg``
budget assumes.  ``--check`` stops there.  Then (CUDA events, medians;
"flushed": L2 flushed by writes before each call, as ``chip_smoke.py``
times; "warm": back to back):

  * (no flag) the six qwen3-4b GEMMs at seq 256 (int32 output) at each
    ring depth at the planned split and at every other split, beside the
    grid route (the times behind ``plan.FIXED_STAGES``); the two routes at
    M = 1 to 128 tokens; the host time of one call on each route
    (descriptor encoding included);
  * ``--diag`` the three clocks (flushed, warm, the profiler's kernel
    duration) on the six GEMMs;
  * ``--trace`` the kernel's text with clock64 stamps inserted
    (``traced_text``): per stage of block (0, 0, 0), each role's waits
    (the instrumentation itself costs hundreds of cycles an event);
  * ``--variants`` the kernel text with one part cut out or changed
    (``VARIANTS``: no transposes, no wgmma, no K-split reduction, the
    loads alone, one TMA stream alone, and designs tried and not kept),
    each built and timed at ``VARIANT_SHAPES``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

QWEN = (("wq", 256, 2560, 4096), ("wk", 256, 2560, 1024),
        ("wv", 256, 2560, 1024), ("wo", 256, 4096, 2560),
        ("mlp_up", 256, 2560, 19456), ("mlp_down", 256, 9728, 2560))


def log(msg: str) -> None:
    print(msg, flush=True)


def launch(route: str, a, w, out, depth: int = 4, splits: int = 1) -> None:
    """One int32 launch on the named route with an explicit split."""
    import torch
    from repro_torch.kernels.dcim_mac import kernel as K
    m, k = a.shape
    n = w.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    if route == "pipelined":
        err = K._lib().dcim_mac_tma(a.data_ptr(), w.data_ptr(), None, None,
                                    out.data_ptr(), m, k, n, 0, depth,
                                    splits, stream)
    else:
        err = K._lib().dcim_mac_grid(a.data_ptr(), w.data_ptr(), None, None,
                                     out.data_ptr(), m, k, n, 0, stream)
    K._check(err, route)


def check() -> bool:
    import torch
    from repro_torch.kernels.build import (library_path, ptxas_report,
                                          wgmma_serialized)
    from repro_torch.kernels.dcim_mac import (dcim_mac_cuda,
                                              dcim_mac_int_cuda, mac_plan,
                                              mac_route, ref)
    from repro_torch.kernels.dcim_mac import kernel as K
    from repro_torch.kernels.tiles import MAC_DEPTHS, smem_bytes
    from repro_torch.kernels.tiles import DEFAULT_TILES
    import dataclasses

    t0 = time.perf_counter()
    K._lib()
    log(f"build: dcim_mac.cu in {time.perf_counter() - t0:.3f} s")
    text = library_path("dcim_mac").with_suffix(".log").read_text()
    report = ptxas_report(text)
    serial = wgmma_serialized(text)
    ok = True
    for fn, use in report.items():
        log(f"ptxas: {fn}: {use}")
        if use["spill_stores"] or use["spill_loads"]:
            ok = False
        if fn in serial:
            log("  ptxas serialized its wgmma pipeline")
            ok = False
        if "tma" in fn and use["registers"] != 168:
            log(f"  TMA kernel has {use['registers']} registers, not 168: "
                "setmaxnreg could wait forever; not launching")
            return False
    for d in MAC_DEPTHS:
        cfg = dataclasses.replace(DEFAULT_TILES["dcim_mac"], depth=d)
        log(f"depth {d}: smem kernel {K.tma_smem_bytes(d)} B, tiles.py "
            f"{smem_bytes('dcim_mac', cfg)} B; max active clusters "
            + ", ".join(f"S={s}: {K.tma_max_clusters(d, s)}"
                        for s in (1, 2, 4, 8)))
    rng = np.random.default_rng(0)
    shapes = [(64, 128, 128), (256, 256, 256), (130, 96, 208),
              (256, 2560, 1024), (300, 640, 384), (512, 512, 512),
              (1, 512, 64), (130, 96, 200)]
    for m, k, n in shapes:
        a = torch.as_tensor(rng.integers(-128, 128, (m, k), dtype=np.int8),
                            device="cuda")
        w = torch.as_tensor(rng.integers(-128, 128, (k, n), dtype=np.int8),
                            device="cuda")
        asc = torch.as_tensor(rng.uniform(0.01, 2, m).astype(np.float32),
                              device="cuda")
        wsc = torch.as_tensor(rng.uniform(0.01, 2, n).astype(np.float32),
                              device="cuda")
        want = ref.dcim_matmul_int_ref(a, w)
        route = mac_route(m, k, n, a.data_ptr(), w.data_ptr())
        res = []
        for d in MAC_DEPTHS:
            got = dcim_mac_int_cuda(a, w, depth=d)
            torch.cuda.synchronize()
            res.append(torch.equal(got, want))
        for dt in (torch.float32, torch.bfloat16):
            got = dcim_mac_cuda(a, w, asc, wsc, dt)
            res.append(torch.equal(got, ref.dcim_matmul_ref(
                a, w, asc, wsc, out_dtype=dt)))
        if route == "pipelined":
            for s in (1, 2, 4, 8):
                if s <= mac_plan(m, k, n).stages:
                    out = torch.empty_like(want)
                    launch("pipelined", a, w, out, 4, s)
                    torch.cuda.synchronize()
                    res.append(torch.equal(out, want))
        diff = (dcim_mac_int_cuda(a, w).double() - want.double()).abs().max()
        log(f"check {m}x{k}x{n} route {route} splits "
            f"{mac_plan(m, k, n).splits}: {res} max|diff| {diff.item()}")
        ok = ok and all(res)
    return ok


def time_ms(fn, reps: int = 20) -> float:
    import chip_smoke
    return chip_smoke._time_ms(fn, reps)


def timings() -> None:
    import torch
    from repro_torch.kernels.dcim_mac import mac_plan, ref
    from repro_torch.kernels.tiles import MAC_DEPTHS
    import chip_smoke

    rng = np.random.default_rng(0)

    def ops(m, k, n):
        a = torch.as_tensor(rng.integers(-128, 128, (m, k), dtype=np.int8),
                            device="cuda")
        w = torch.as_tensor(rng.integers(-128, 128, (k, n), dtype=np.int8),
                            device="cuda")
        return a, w, torch.empty((m, n), dtype=torch.int32, device="cuda")

    for name, m, k, n in QWEN:
        a, w, out = ops(m, k, n)
        want = ref.dcim_matmul_int_ref(a, w)
        plan = mac_plan(m, k, n)
        bound = chip_smoke._bound_ms(m, k, n, 4, False)[0]
        row = [f"grid {time_ms(lambda: launch('grid', a, w, out)):.6f}"]
        for d in MAC_DEPTHS:
            row.append(f"d{d}/S{plan.splits} "
                       f"{time_ms(lambda: launch('pipelined', a, w, out, d, plan.splits)):.6f}")
        for s in (1, 2, 4, 8):
            if s != plan.splits and s <= plan.stages:
                row.append(f"d4/S{s} "
                           f"{time_ms(lambda: launch("pipelined", a, w, out, 4, s)):.6f}")
                if not torch.equal(out, want):
                    row.append("WRONG")
        log(f"time {name} {m}x{k}x{n} plan S={plan.splits} blocks "
            f"{plan.blocks}, bound {bound:.6f} ms: " + ", ".join(row))
    for m in (1, 8, 16, 32, 64, 128):
        a, w, out = ops(m, 2560, 4096)
        tg = time_ms(lambda: launch("grid", a, w, out))
        s = mac_plan(m, 2560, 4096).splits
        tt = time_ms(lambda: launch("pipelined", a, w, out, 4, s))
        log(f"rows M={m} (K 2560, N 4096): grid {tg:.6f} ms, pipelined "
            f"(S={s}) {tt:.6f} ms")
    a, w, out = ops(64, 128, 128)
    for route in ("grid", "pipelined"):
        for _ in range(100):
            launch(route, a, w, out)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2000):
            launch(route, a, w, out)
        host = (time.perf_counter() - t) / 2000 * 1e6
        torch.cuda.synchronize()
        log(f"host: one {route} call (64x128x128) {host:.3f} us")


def warm_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn()`` launched back to back, L2 warm."""
    import torch
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced_ms(fn, reps: int = 10) -> float:
    """Median duration of the ``dcim_mac`` kernels ``fn()`` launches as
    the profiler sees them, L2 flushed (by writes) before each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    durs = [e.device_time for e in prof.events()
            if "dcim_mac" in e.name and e.device_time > 0]
    return float(np.median(durs)) / 1e3 if durs else float("nan")


def diag() -> None:
    """Each clock on a few GEMMs: chip_smoke's (L2 flushed by writes),
    back to back with L2 warm, and the profiler's kernel duration."""
    import torch
    from repro_torch.kernels.dcim_mac import mac_plan
    rng = np.random.default_rng(0)
    for name, m, k, n in QWEN:
        a = torch.as_tensor(rng.integers(-128, 128, (m, k), dtype=np.int8),
                            device="cuda")
        w = torch.as_tensor(rng.integers(-128, 128, (k, n), dtype=np.int8),
                            device="cuda")
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        plan = mac_plan(m, k, n)
        for label, fn in (
                ("grid", lambda: launch("grid", a, w, out)),
                (f"tma S={plan.splits}", lambda: launch(
                    "pipelined", a, w, out, 4, plan.splits)),
                ("tma S=1", lambda: launch("pipelined", a, w, out, 4, 1))):
            log(f"diag {name} {label}: flushed {time_ms(fn):.6f} ms, warm "
                f"{warm_ms(fn):.6f} ms, traced {traced_ms(fn):.6f} ms")


# --trace: clock64 stamps of block (0, 0, 0), stage t < 128, into
# g_trace[event * 128 + t], inserted into the kernel's text after the
# line each event names (the shipped source carries none of it)
_TRACE_DEFS = """
__device__ unsigned long long* g_trace;
#define TRACE(e, t)                                                        \\
  do {                                                                     \\
    if (g_trace != nullptr && blockIdx.x + blockIdx.y + blockIdx.z == 0 && \\
        (t) < 128)                                                         \\
      g_trace[(e) * 128 + (t)] = clock64();                                \\
  } while (0)
"""
_TRACE_POINTS = (  # (after this line, the event)
    ("                     n0, (t_begin + tw) * BK);\n",
     "            TRACE(0, tw);\n"),
    ("    mbar_wait(a_full0 + 8 * s, (t / DEPTH) & 1);\n",
     "    if (threadIdx.x == 128) TRACE(1, t);\n"),
    ("    mbar_wait(wt_full0 + 8 * b, (t / WT_BUFS) & 1);\n",
     "    if (threadIdx.x == 128) TRACE(2, t);\n"),
    ("      wgmma_wait<1>();\n      fence_acc(acc0);\n      fence_acc(acc1);\n"
     "    }\n", "    if (threadIdx.x == 128) TRACE(3, t);\n"),
    ("          mbar_wait(wt_empty0 + 8 * b, ((t / WT_BUFS) & 1) ^ 1);\n",
     "        if (tid == 32) TRACE(4, t);\n"),
    ("        mbar_arrive(w_empty0 + 8 * s);\n",
     "        if (tid == 32) TRACE(5, t);\n"),
    ("            wt + b * W_STAGE, warp - 1, lane, rot);\n",
     "        if (tid == 32) TRACE(6, t);\n"),
    ("                     (t_begin + ta) * BK, m0);\n",
     "            TRACE(7, ta);\n"),
)
_TRACE_SETTER = """
extern "C" int dcim_mac_set_trace(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(tma::g_trace, &p, sizeof(p)));
}
"""


def traced_text(text: str) -> str:
    """The kernel's text with the --trace stamps inserted."""
    text = text.replace("namespace tma {\n", "namespace tma {\n" + _TRACE_DEFS,
                        1)
    for line, event in _TRACE_POINTS:
        assert text.count(line) == 1, line
        text = text.replace(line, line + event)
    return text + _TRACE_SETTER


def trace() -> None:
    """Stage timestamps of block (0, 0, 0) of the TMA kernel: per stage,
    clock64 cycles after the first W load's issue of the producer's W
    issue (Pw) and A issue (Pa), the consumer's A wait (F), its
    transposed-W wait (W), its wgmma_wait<1> (C), and the transposer's
    start (X0), its last store (Xs) and its end (X1)."""
    import torch
    from repro_torch.kernels.build import (CSRC, build_source,
                                          wgmma_serialized)
    from repro_torch.kernels.dcim_mac import kernel as K
    text = traced_text((CSRC / "dcim_mac.cu").read_text())
    path = build_source("dcim_mac_trace", text)
    lib = K.bind(path)
    log(f"trace build: {len(wgmma_serialized(path.with_suffix('.log').read_text()))}"
        " kernels with a serialized wgmma pipeline")
    lib.dcim_mac_set_trace.argtypes = [ctypes.c_void_p]
    lib.dcim_mac_set_trace.restype = ctypes.c_int
    buf = torch.zeros(8 * 128, dtype=torch.int64, device="cuda")
    K._check(lib.dcim_mac_set_trace(buf.data_ptr()), "set_trace")
    rng = np.random.default_rng(0)
    for name, m, k, n, s, d in (("wk", 256, 2560, 1024, 1, 4),
                                ("wk", 256, 2560, 1024, 1, 2),
                                ("wq_m1", 1, 2560, 4096, 1, 4)):
        a = torch.as_tensor(rng.integers(-128, 128, (m, k), dtype=np.int8),
                            device="cuda")
        w = torch.as_tensor(rng.integers(-128, 128, (k, n), dtype=np.int8),
                            device="cuda")
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        for _ in range(3):
            buf.zero_()
            K._check(lib.dcim_mac_tma(a.data_ptr(), w.data_ptr(), None, None,
                                      out.data_ptr(), m, k, n, 0, d, s,
                                      torch.cuda.current_stream()
                                      .cuda_stream), name)
            torch.cuda.synchronize()
        ev = buf.view(8, 128).cpu().numpy()
        t = min(-(-k // 128) // s, 128)
        base = ev[0, 0]
        log(f"trace {name} {m}x{k}x{n} S={s} depth {d}: cycles after the "
            "first issue")
        for i in range(t):
            log(f"  stage {i}: " + " ".join(
                f"{lab} {int(ev[e, i] - base)}" for e, lab in
                enumerate(("Pw", "F", "W", "C", "X0", "X1", "Xs", "Pa"))))


# Variants of the TMA kernel's text, each with one part cut out or
# changed, for --variants: where a block's time goes.  The outputs of those
# that cut a part are wrong; only their times are read.
_W_LOAD = """            tma_load(smem_u32(w_ring + (tw % W_BUFS) * W_STAGE), &w_map, bar,
                     n0, (t_begin + tw) * BK);"""
_A_LOAD = """            tma_load(smem_u32(a_ring + (ta % DEPTH) * A_STAGE), &a_map, bar,
                     (t_begin + ta) * BK, m0);"""
_W_MAP = "!make_map(&w_map, w, K, N, BK, BN, CU_TENSOR_MAP_SWIZZLE_128B)"
_A_MAP = "!make_map(&a_map, a, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B)"
_NO_TRANSPOSE = [("        transpose_stage(\n",
                  "        if (false) transpose_stage(\n")]
_NO_WGMMA = [("    if (m0 + row0 + 64 < M)\n", "    if (false)\n"),
             ("    else if (m0 + row0 < M)\n", "    else if (false)\n")]
_NO_W_LOADS = [("            mbar_expect_tx(bar, W_STAGE);\n" + _W_LOAD,
                "            mbar_arrive(bar);")]
_NO_A_LOADS = [("            mbar_expect_tx(bar, A_STAGE);\n" + _A_LOAD,
                "            mbar_arrive(bar);")]
_NO_REDUCE = [("for (int i0 = rank * per; i0 < (int)(rank + 1) * per;",
               "for (int i0 = rank * per; i0 < 0;")]
_NO_FENCE = [('        asm volatile("fence.proxy.async.shared::cta;\\n" ::: '
              '"memory");', "")]
_W5 = [("constexpr int W_BUFS = 3;", "constexpr int W_BUFS = 5;")]
_P128 = [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
          "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")]
# each block starts its K walk at its own stage (7 x strip mod T)
_STAGGER_W = [
    ("  const int T = (int)((long long)(blockIdx.z + 1) * total / splits)"
     " - t_begin;\n",
     "  const int T = (int)((long long)(blockIdx.z + 1) * total / splits)"
     " - t_begin;\n"
     "  const int rot_k = T > 0 ? (int)((blockIdx.x * 7u) % (unsigned)T)"
     " : 0;\n"),
    ("n0, (t_begin + tw) * BK);", "n0, (t_begin + (tw + rot_k) % T) * BK);")]
_STAGGER = _STAGGER_W + [("(t_begin + ta) * BK, m0);",
                          "(t_begin + (ta + rot_k) % T) * BK, m0);")]


def _w_split(n: int) -> list[tuple[str, str]]:
    """W stages loaded as n boxes of BK / n rows."""
    return [(_W_LOAD, f"""            for (int p = 0; p < {n}; ++p)
              tma_load(smem_u32(w_ring + (tw % W_BUFS) * W_STAGE
                                + p * (BK / {n}) * BN), &w_map, bar, n0,
                       (t_begin + tw) * BK + p * (BK / {n}));"""),
            (_W_MAP, _W_MAP.replace("BK, BN", f"BK / {n}, BN"))]


def _a_split(n: int) -> list[tuple[str, str]]:
    """A stages loaded as n boxes of BM / n rows."""
    return [(_A_LOAD, f"""            for (int p = 0; p < {n}; ++p)
              tma_load(smem_u32(a_ring + (ta % DEPTH) * A_STAGE
                                + p * (BM / {n}) * BK), &a_map, bar,
                       (t_begin + ta) * BK, m0 + p * (BM / {n}));"""),
            (_A_MAP, _A_MAP.replace("BM, BK", f"BM / {n}, BK"))]


def _prefetch(n: int) -> list[tuple[str, str]]:
    """Each W load also pulls the W stage n ahead into L2
    (cp.async.bulk.prefetch.tensor)."""
    return [("                     n0, (t_begin + tw) * BK);\n",
             f"""                     n0, (t_begin + tw) * BK);
            if (tw + {n} < T)
              asm volatile(
                  "cp.async.bulk.prefetch.tensor.2d.L2.global.tile"
                  " [%0, {{%1, %2}}];"
                  :: "l"(reinterpret_cast<uint64_t>(&w_map)), "r"(n0),
                     "r"((t_begin + tw + {n}) * BK) : "memory");
""")]


# W read as contiguous 16 KB blocks of the same bytes (each strip's K x 128
# bytes laid end to end, as if W were stored strip-major): the W stream's
# rate without the row-major layout's 128-byte pieces
_W_CONTIGUOUS = [
    (_W_MAP, "!make_map(&w_map, w, (int)((long long)K * N / BN), BN, BK, BN,"
             " CU_TENSOR_MAP_SWIZZLE_128B)"),
    ("n0, (t_begin + tw) * BK);",
     "0, (int)blockIdx.x * K + (t_begin + tw) * BK);")]


def _blocking_producer(text: str) -> list[tuple[str, str]]:
    """The producer waits for each buffer in stage order instead of
    polling both rings."""
    i0 = text.index("        int ta = 0, tw = 0;\n")
    i1 = text.index("      }\n    } else {\n      // transposers")
    return [(text[i0:i1], """        for (int t = 0; t < T; ++t) {
          const int sw = t % W_BUFS, sa = t % DEPTH;
          if (t >= W_BUFS)
            mbar_wait(w_empty0 + 8 * sw, ((t / W_BUFS) & 1) ^ 1);
          mbar_expect_tx(w_full0 + 8 * sw, W_STAGE);
          tma_load(smem_u32(w_ring + sw * W_STAGE), &w_map, w_full0 + 8 * sw,
                   n0, (t_begin + t) * BK);
          if (t >= DEPTH)
            mbar_wait(a_empty0 + 8 * sa, ((t / DEPTH) & 1) ^ 1);
          mbar_expect_tx(a_full0 + 8 * sa, A_STAGE);
          tma_load(smem_u32(a_ring + sa * A_STAGE), &a_map, a_full0 + 8 * sa,
                   (t_begin + t) * BK, m0);
        }
""")]


_LOADS = _NO_TRANSPOSE + _NO_WGMMA
VARIANTS = {
    "shipped": [],
    "no_transpose": _NO_TRANSPOSE,
    "no_wgmma": _NO_WGMMA,
    "no_reduce": _NO_REDUCE,
    "loads": _LOADS,
    "w_loads": _LOADS + _NO_A_LOADS,
    "a_loads": _LOADS + _NO_W_LOADS,
    "no_fence": _NO_FENCE,
    "blocking_producer": _blocking_producer,
    "stagger": _STAGGER,
    "w_loads_stagger": _LOADS + _NO_A_LOADS + _STAGGER_W,
    "w_loads_w5": _LOADS + _NO_A_LOADS + _W5,
    "w_loads_p128": _LOADS + _NO_A_LOADS + _P128,
    "w_loads_w4": _LOADS + _NO_A_LOADS + _w_split(4),
    "a_loads_a4": _LOADS + _NO_W_LOADS + _a_split(4),
    "prefetch8": _prefetch(8),
    "w_loads_prefetch8": _LOADS + _NO_A_LOADS + _prefetch(8),
    "w_loads_contiguous": _LOADS + _NO_A_LOADS + _W_CONTIGUOUS,
}
# the ring depths a variant launches at, where not every depth fits
_DEPTHS = {"w_loads_w5": (2,)}

# (name, M, K, N, K split, ring depth) of the --variants runs
VARIANT_SHAPES = (("wq", 256, 2560, 4096, 1, 4), ("wq", 256, 2560, 4096, 2, 4),
                  ("wq+128", 256, 2560, 4224, 1, 4),
                  ("wk", 256, 2560, 1024, 8, 4), ("wo", 256, 4096, 2560, 4, 4),
                  ("mlp_up", 256, 2560, 19456, 1, 4),
                  ("mlp_up", 256, 2560, 19456, 1, 2),
                  ("mlp_up", 256, 2560, 19456, 2, 4),
                  ("mlp_down", 256, 9728, 2560, 4, 4))


def variants(only: list[str] | None = None) -> None:
    """Each VARIANTS text (or those named in ``only``) built and timed (L2
    flushed, and back to back) at the VARIANT_SHAPES."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.build import CSRC, build_source
    from repro_torch.kernels.dcim_mac import kernel as K
    text = (CSRC / "dcim_mac.cu").read_text()
    texts = {}
    for name, subs in VARIANTS.items():
        if only and name not in only:
            continue
        t = text
        for old, new in (subs(text) if callable(subs) else subs):
            assert old in t, (name, old)
            t = t.replace(old, new)
        texts[name] = t
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: K.bind(build_source(f"dcim_mac_{kv[0]}", kv[1])),
            texts.items())))
    rng = np.random.default_rng(0)
    for name, m, k, n, s, d in VARIANT_SHAPES:
        a = torch.as_tensor(rng.integers(-128, 128, (m, k), dtype=np.int8),
                            device="cuda")
        w = torch.as_tensor(rng.integers(-128, 128, (k, n), dtype=np.int8),
                            device="cuda")
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        row = []
        for vname, lib in libs.items():
            if d not in _DEPTHS.get(vname, (2, 3, 4)):
                continue

            def fn(lib=lib):
                K._check(lib.dcim_mac_tma(
                    a.data_ptr(), w.data_ptr(), None, None, out.data_ptr(),
                    m, k, n, 0, d, s,
                    torch.cuda.current_stream().cuda_stream), vname)
            row.append(f"{vname} {time_ms(fn):.6f}/{warm_ms(fn):.6f}")
        log(f"variants {name} {m}x{k}x{n} S={s} depth {d} (flushed/warm "
            "ms): " + ", ".join(row))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma-separated VARIANTS names for --variants")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    log(smi.stdout.strip())
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1:]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, nvcc {nvcc}")
    if not check():
        log("check FAILED")
        return 1
    log("check passed")
    if args.variants:
        variants([v for v in args.only.split(",") if v] or None)
    elif args.trace:
        trace()
    elif args.diag:
        diag()
    elif not args.check:
        timings()
    return 0


if __name__ == "__main__":
    sys.exit(main())
