"""The per-layer metrics read from the program's own spans
(:mod:`perfbench.lib.program_spans`): the eleven readers on a record built
by hand, with spans made through ``repro_torch.obs`` on a clock the test
sets, and a ``--trace 1`` run of each small cell on the CPU."""

import dataclasses
import math
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest, program_spans  # noqa: E402
from perfbench.run import run_cell  # noqa: E402
from repro_torch.obs import get_registry, tracer  # noqa: E402

MS = 1_000_000
NEW = {  # metric: its value on the record by hand
    "attn_host_ms.decode": 2.5, "moe_route_host_ms.decode": 1.0,
    "moe_experts_host_ms.decode": 2.5, "mamba_host_ms.decode": 0.5,
    "fake_quant_host_ms.decode": 1.5, "attn_idle_ms.decode": 1.75,
    "moe_route_idle_ms.decode": 0.75, "moe_experts_idle_ms.decode": 1.75,
    "mamba_idle_ms.decode": 0.5, "moe_dropped_pct.decode": 20.0,
    "moe_slot_fill_pct.decode": 100 * 160 / 240}

# Two traced decode steps then a prefill, in ms on the tracer's clock:
# (name, start, end, parent, tags); the parent is an index in this list.
STEP0 = [("serve.decode_step", 1, 9, None, {}),
         ("attn", 2, 4, 0, {}), ("fake_quant", 2.5, 3, 1, {}),
         ("moe.route", 4, 5, 0, {"routed": 100, "slots": 120, "kept": 90}),
         ("moe.experts", 5, 8, 0, {}), ("fake_quant", 6, 7, 4, {}),
         ("mamba", 8, 8.5, 0, {})]
STEP1 = [("serve.decode_step", 11, 19, None, {}),
         ("attn", 12, 15, 0, {}), ("fake_quant", 13, 14, 1, {}),
         ("moe.route", 15, 16, 0, {"routed": 100, "slots": 120, "kept": 70}),
         ("moe.experts", 16, 18, 0, {}), ("fake_quant", 16.5, 17, 4, {}),
         ("mamba", 18, 18.5, 0, {})]
PREFILL = [("serve.prefill", 21, 29, None, {}), ("attn", 22, 28, 0, {})]


@pytest.fixture
def clean_tracer():
    clock = tracer.clock
    tracer.clear()
    yield
    tracer.configure(enabled=False, clock=clock)
    tracer.clear()


def _record(spans):
    """Record ``spans`` (the list's layout) through ``obs``, on a clock that
    reads 0 at the root; return the root's offset to the profiler's
    clock."""
    tracer.configure(enabled=True, clock=lambda: 0.0)
    handles = []
    for name, s, e, parent, tags in spans:
        if parent is None:
            h = tracer.start_trace(name, tags=tags, start_s=s / 1e3)
        else:
            h = tracer.start(name, parent=handles[parent].context,
                             tags=tags, start_s=s / 1e3)
        handles.append(h)
    for h, (_, _, e, _, _) in reversed(list(zip(handles, spans))):
        h.finish(end_s=e / 1e3)
    tracer.configure(enabled=False)
    return handles[0].span.unix_offset_ns


def _ev(kind):
    return dict(kind=kind, job=0, t0=0, t_ret=1, t_end=2, tokens=4)


def _hand_record():
    """The record of the module's three traced steps, on the profiler's
    clock; each step's three harness spans around its root; device ops
    at 3-3.5 and 4.5-6.5 ms (step 0), 12-13 ms (step 1)."""
    offsets = [_record(STEP0), _record(STEP1), _record(PREFILL)]

    def ns(t_ms, step):
        return round(t_ms * MS) + offsets[step]

    tr_spans = []
    for step, label in enumerate(("decode_call", "decode_call", "prefill")):
        base = 10 * step
        tr_spans += [(label, ns(base + 0.5, step), ns(base + 9.5, step)),
                     ("argmax", ns(base + 9.5, step), ns(base + 9.7, step)),
                     ("token_copy", ns(base + 9.7, step),
                      ns(base + 10, step))]
    ops = [("k", ns(3, 0), ns(3.5, 0), "kernel"),
           ("k", ns(4.5, 0), ns(6.5, 0), "kernel"),
           ("k", ns(12, 1), ns(13, 1), "kernel")]
    tr = {"window_ns": [tr_spans[0][1], tr_spans[-1][2]], "spans": tr_spans,
          "ops": ops, "events": [_ev("decode"), _ev("decode"),
                                 _ev("prefill")]}
    return {"setup_s": 1.0, "window_s": 1.0, "events": [], "trace": tr,
            "peaks": None, "matmul_substrings": []}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_on_a_record_by_hand(name, clean_tracer):
    # a step of an earlier run in the same process is not read
    _record(STEP0)
    time.sleep(0.05)
    rec = _hand_record()
    assert manifest.load_reader(name)(rec) == pytest.approx(NEW[name])


def test_readers_read_nothing_of_a_partial_trace(clean_tracer):
    rec = _hand_record()
    steps = program_spans.decode_steps(rec)
    assert [len(sp) for *_, sp in steps] == [7, 7]
    assert [sp[0][0] for *_, sp in steps] == ["serve.decode_step"] * 2
    # a traced decode step without its root: no reading at all
    rec["trace"]["events"][2] = _ev("decode")
    for name in NEW:
        assert manifest.load_reader(name)(rec) is None
    # a layer the steps lack
    tracer.clear()
    rec = _hand_record()
    assert program_spans.host_ms(rec, "no.such.layer") is None


def test_readers_read_nothing_once_spans_were_dropped(clean_tracer):
    rec = _hand_record()
    dropped = get_registry().counter("obs/spans_dropped")
    before = dropped.value
    dropped.set(1)
    try:
        for name in NEW:
            assert manifest.load_reader(name)(rec) is None
    finally:
        dropped.set(before)
    assert manifest.load_reader("attn_host_ms.decode")(rec) == 2.5


def test_manifest_lists_each_reader_where_it_reads():
    per_layer = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["layer"] == "model" and m["moves"] == "decode_tokens_per_s"
        moe = name.startswith("moe_")
        assert m["source"] == ("program_counter" if moe and "pct" in name
                               else "program_span")
        cells = set(m["workloads"])
        if moe:
            assert cells == {"granite-moe-3b.decode"}
        elif name.startswith("mamba"):
            assert cells == {"zamba2-1.2b.decode"}
        else:
            assert cells == {"granite-moe-3b.decode", "zamba2-1.2b.decode"}


SMALL = {"batch": 8, "prompt_len": 8, "output_len": 6, "cache_len": 16}
ARCH = {"granite-moe-3b.decode": "granite-moe-3b-a800m",
        "zamba2-1.2b.decode": "zamba2-1.2b"}


@pytest.mark.parametrize("name", sorted(ARCH))
def test_traced_cpu_run_prints_every_new_metric(name):
    from repro_torch.configs import smoke_config

    cell = manifest.load_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL))
    out = run_cell(cell, 2**33 + 29, 1.5, True, "cpu", time.perf_counter(),
                   config=smoke_config(ARCH[name]))
    want = {m["name"] for m in cell.per_layer} & set(NEW)
    assert len(want) == (9 if name.startswith("granite") else 5)
    assert want <= set(out["metrics"])
    assert all(math.isfinite(out["metrics"][m]["value"]) for m in want)
    assert out["correct"]
