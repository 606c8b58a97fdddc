"""The result line's schema from a whole run on the CPU at a small size,
and the metric readers and the trace reduction on a record built by hand."""

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest, trace  # noqa: E402
from perfbench.run import run_cell  # noqa: E402

SMALL = {"batch": 8, "prompt_len": 8, "output_len": 6, "cache_len": 16}
ARCH = {"granite-moe-3b.decode": "granite-moe-3b-a800m",
        "zamba2-1.2b.decode": "zamba2-1.2b"}


def small_cell(name, **traffic):
    cell = manifest.load_cell(name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL,
                                                  **traffic))


def check_line(out, cell, trace_run):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] >= 0
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    want = {m["name"]: m["unit"] for m in cell.metrics(trace_run)}
    for name, m in out["metrics"].items():
        assert want[name] == m["unit"] and math.isfinite(m["value"])
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace_run:
        assert {"busy_s", "window_s"} <= set(dev)
        bd = out["breakdown"]
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    json.dumps(out)


@pytest.mark.parametrize("trace_run", [False, True])
@pytest.mark.parametrize("name", sorted(ARCH))
def test_result_line_of_a_cpu_run(name, trace_run):
    from repro_torch.configs import smoke_config

    cell = small_cell(name)
    out = run_cell(cell, 2**33 + 11, 1.5, trace_run, "cpu",
                   time.perf_counter(), config=smoke_config(ARCH[name]))
    check_line(out, cell, trace_run)
    assert out["correct"]
    if not trace_run:
        assert {"decode_tokens_per_s", "itl_p90_ms", "setup_s"} \
            <= set(out["metrics"])


def _ev(kind, t0, t_end, **kw):
    return dict(kind=kind, job=0, t0=t0, t_ret=t0 + 1_000_000, t_end=t_end,
                tokens=4, **kw)


def test_readers_on_a_record_by_hand():
    events = [_ev("decode", 0, 100_000_000, gap_ns=100_000_000, filled=9,
                  flops=4e12, bytes=2e10),
              _ev("decode", 100_000_000, 300_000_000, gap_ns=200_000_000,
                  filled=10, flops=4e12, bytes=2e10),
              _ev("prefill", 300_000_000, 500_000_000),
              _ev("decode", 500_000_000, 600_000_000, gap_ns=100_000_000,
                  filled=9, flops=4e12, bytes=2e10)]
    # one traced decode step: spans 0-10 ms; kernels 1-3 and 2-4 (a gemm),
    # 6-7 ms; a prefill step after it
    ms = 1_000_000
    tr = {"window_ns": [0, 30 * ms],
          "spans": [("decode_call", 0, 5 * ms), ("argmax", 5 * ms, 8 * ms),
                    ("token_copy", 8 * ms, 10 * ms),
                    ("prefill", 10 * ms, 25 * ms), ("argmax", 25 * ms,
                                                    28 * ms),
                    ("token_copy", 28 * ms, 30 * ms)],
          "ops": [("a_kernel", 1 * ms, 3 * ms, "kernel"),
                  ("nvjet_tst_gemm", 2 * ms, 4 * ms, "kernel"),
                  ("Memcpy DtoH", 6 * ms, 7 * ms, "memcpy"),
                  ("prefill_kernel", 11 * ms, 20 * ms, "kernel")],
          "events": [_ev("decode", 0, 10 * ms, flops=1e9, bytes=3.35e6,
                         gap_ns=1, filled=9),
                     _ev("prefill", 10 * ms, 30 * ms)]}
    rec = {"setup_s": 12.5, "window_s": 0.6, "events": events, "trace": tr,
           "peaks": {"bf16_dense_flops_per_s": 1e12,
                     "hbm_bytes_per_s": 1e12},
           "matmul_substrings": ["gemm", "nvjet"]}

    def read(name):
        return manifest.load_reader(name)(rec)

    assert read("setup_s") == 12.5
    assert read("decode_tokens_per_s") == pytest.approx(12 / 0.6)
    assert read("itl_p90_ms") == 200.0
    assert read("dispatch_ms.decode") == 1.0
    assert read("kernels_per_step.decode") == 2
    # device time of the decode step: 2 + 2 + 1 ms, the gemm 2 of it
    assert read("matmul_busy_pct.decode") == pytest.approx(40.0)
    # busy: union 1-4 and 6-7 ms = 4 ms against the window's mean step,
    # (100 + 200 + 100) / 3 ms
    assert read("device_idle_pct.decode") == pytest.approx(97.0)
    # need: max(1e9 / 1e12, 3.35e6 / 1e12) = 1 ms of 4 busy
    assert read("kernel_roofline_pct.decode") == pytest.approx(25.0)
    assert read("mfu.decode") == pytest.approx(100 * 12e12 / (0.6 * 1e12))
    assert trace.busy_ns(tr) == 13 * ms
    assert trace.idle_gaps(tr) == [("decode_call", 0, 1 * ms),
                                   ("decode_call", 4 * ms, 2 * ms),
                                   ("argmax", 7 * ms, 4 * ms),
                                   ("prefill", 20 * ms, 10 * ms)]
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["prefill_kernel", 0.009]


def test_readers_leave_out_what_they_cannot_read():
    rec = {"setup_s": 1.0, "window_s": 1.0, "events": [], "trace": None,
           "peaks": None, "matmul_substrings": []}
    for m in manifest.load_manifest()["per_layer"]:
        assert manifest.load_reader(m["name"])(rec) is None
    for name in ("decode_tokens_per_s", "itl_p90_ms"):
        assert manifest.load_reader(name)(rec) is None


def test_union_merges_overlaps_and_clips():
    assert trace.union_ns([(0, 5), (3, 8), (10, 12), (11, 20)], 2, 15) \
        == 6 + 5
