"""The port's layer spans in its serving steps (``repro_torch.obs``), on the
CPU with the smoke granite and zamba2 configs: what one decode step records
under ``torch.profiler``, where its spans sit on the profiler's clock, that
a step records nothing and opens no profiler range while tracing is off,
the MoE capacity count and kernel tag the ``moe.route`` span carries,
and the benchmark's reader of that tag on a record written by hand."""

import dataclasses
import math
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler
import torch.profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.moe import MoeMlp, _top_k_dispatch
from repro_torch.models.zamba2 import _segments
from repro_torch.obs import profiler_ns, tracer
from repro_torch.serve.step import (greedy_argmax, make_decode_step,
                                    make_prefill)

ARCHS = ("granite-moe-3b-a800m", "zamba2-1.2b")
ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000


@pytest.fixture(autouse=True)
def quiet_tracer():
    clock = tracer.clock
    tracer.configure(enabled=False)
    tracer.clear()
    yield
    tracer.configure(enabled=False, clock=clock)
    tracer.clear()


def _served(arch):
    """(cfg, model, decode step, state, tokens) after a prefill of 4 x 8."""
    cfg = smoke_config(arch)
    api = get_model(cfg)
    model = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 8),
                            generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, state = make_prefill(api, 16)(model, prompts)
    return cfg, model, make_decode_step(api), state, greedy_argmax(logits)


def _profiled_step(arch):
    """One decode step under the profiler, inside a ``decode_call`` range
    as the benchmark's traced steps run it: (cfg, model, spans, the
    profiler's CPU ranges by name)."""
    cfg, model, decode, state, tok = _served(arch)
    tracer.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("decode_call"):
            decode(model, state, tok)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return cfg, model, tracer.spans(), ranges


def _count(spans, name):
    return sum(s.name == name for s in spans)


def _dcim_linears(module):
    return sum(isinstance(m, L.DcimLinear) for m in module.modules())


@pytest.mark.parametrize("arch", ARCHS)
def test_one_decode_step_is_one_root_over_its_layers(arch):
    cfg, model, spans, _ = _profiled_step(arch)
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "serve.decode_step"
    assert root.tags == {"model": cfg.name, "batch": 4}
    assert {s.trace_id for s in spans} == {root.trace_id}
    by_id = {s.span_id: s for s in spans}
    assert all(s.parent_id in by_id for s in spans if s is not root)
    n = cfg.n_layers
    assert cfg.dcim_enabled
    if arch.startswith("granite"):
        assert _count(spans, "attn") == n
        assert _count(spans, "moe.route") == n
        assert _count(spans, "moe.experts") == n
        # two per linear (weight, activation), and the experts' three
        # weights and their input
        want_fq = 2 * _dcim_linears(model) + 4 * n
    else:
        runs = len(_segments(cfg))
        assert _count(spans, "mamba") == n
        assert _count(spans, "attn") == runs
        want_fq = 2 * (_dcim_linears(model.mamba)
                       + runs * _dcim_linears(model.shared_attn))
    assert _count(spans, "fake_quant") == want_fq
    assert {by_id[s.parent_id].name for s in spans
            if s.name == "fake_quant"} <= {"attn", "moe.experts", "mamba",
                                           "serve.decode_step"}


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_sit_on_their_profiler_ranges(arch):
    _, _, spans, ranges = _profiled_step(arch)
    names = {s.name for s in spans}
    assert "serve.decode_step" in names
    for name in names:
        ours = sorted(profiler_ns(s) for s in spans if s.name == name)
        theirs = sorted(ranges[name])
        assert len(ours) == len(theirs)
        for (s, e), (rs, re_) in zip(ours, theirs):
            assert abs(s - rs) < 1_000_000 and abs(e - re_) < 1_000_000, \
                (name, s - rs, e - re_)


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_off_records_nothing_and_opens_no_range(arch, monkeypatch):
    cfg, model, decode, state, tok = _served(arch)
    calls = []
    real = torch.autograd.profiler.record_function

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    tracer.clear()
    with torch.no_grad():
        decode(model, state, tok)
    assert tracer.spans() == [] and calls == []
    # on without a profiler: the spans record, still without a range
    tracer.configure(enabled=True)
    with torch.no_grad():
        decode(model, state, tok)
    assert _count(tracer.spans(), "serve.decode_step") == 1
    assert calls == []


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_route_tags_count_the_dispatch(capacity_factor):
    cfg = smoke_config("granite-moe-3b-a800m")
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    mlp = MoeMlp(cfg, torch.float32, "cpu")
    mlp.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    tracer.configure(enabled=True)
    with torch.no_grad(), tracer.start_trace("serve.decode_step"):
        mlp(x)
    (route,) = [s for s in tracer.spans() if s.name == "moe.route"]

    # the plain count: the router again, the slot assignment, its bits
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    g, s = 1, 32
    gates = torch.softmax(x.reshape(g, s, -1) @ mlp.router, dim=-1)
    cap = max(1, math.ceil(s * k / e * capacity_factor))
    dispatch, _, _ = _top_k_dispatch(gates, k, cap)
    kept = int(dispatch.any(-1).sum())
    assert route.tags == {"kernel": False, "routed": g * s * k,
                          "slots": g * e * cap, "kept": kept}
    assert isinstance(route.tags["kept"], int)
    if capacity_factor < 1:
        assert kept < g * s * k


def test_profiler_ns_shifts_by_the_roots_offset():
    now = [100.0]
    tracer.configure(enabled=True, clock=lambda: now[0])
    t_unix = time.time_ns()
    with tracer.start_trace("serve.decode_step") as root:
        now[0] = 100.25
        with tracer.span("attn") as child:
            now[0] = 100.5
        now[0] = 101.0
    offset = root.span.unix_offset_ns
    assert child.span.unix_offset_ns == offset
    assert abs(offset + 100 * 10**9 - t_unix) < 10**8
    assert profiler_ns(child.span) == (100_250_000_000 + offset,
                                       100_500_000_000 + offset)
    assert profiler_ns(root.span) == (100_000_000_000 + offset,
                                      101_000_000_000 + offset)


def _decode_record(steps: list) -> dict:
    """A ``--trace 1`` record of one traced decode step per entry of
    ``steps``, each a list of ``moe.route`` spans' ``kernel`` tags (None:
    untagged) recorded under the step's root, 1 ms apart; the harness's
    spans of each step around its root on the profiler's clock."""
    spans, events = [], []
    for i, tags in enumerate(steps):
        base = 0.1 * i
        tracer.configure(enabled=True, clock=lambda: 0.0)
        root = tracer.start_trace("serve.decode_step", start_s=base)
        for j, kernel in enumerate(tags):
            h = tracer.start("moe.route", parent=root.context,
                             tags={} if kernel is None else {"kernel": kernel},
                             start_s=base + (1 + j) / 1e3)
            h.finish(end_s=base + (1.5 + j) / 1e3)
        root.finish(end_s=base + (2 + len(tags)) / 1e3)
        tracer.configure(enabled=False)
        t0 = root.span.unix_offset_ns + 100 * i * MS
        t1 = t0 + 50 * MS
        spans += [("decode_call", t0, t1), ("argmax", t1, t1 + MS),
                  ("token_copy", t1 + MS, t1 + 2 * MS)]
        events.append(dict(kind="decode", job=0, t0=0, t_ret=1, t_end=2,
                           tokens=4))
    tr = {"window_ns": [spans[0][1], spans[-1][2]], "spans": spans,
          "ops": [], "events": events}
    return {"setup_s": 1.0, "window_s": 1.0, "events": [], "trace": tr,
            "peaks": None, "matmul_substrings": []}


@pytest.mark.parametrize("steps,want", [
    ([[True, True, True], [True]], 100.0),
    ([[True, False, True, False], [True, True]], 100 * 4 / 6),
    ([[False, False], [False]], 0.0),
    ([[True, None], [True]], None),         # a span without the tag
    ([[], []], None)], ids=str)             # no moe.route span
def test_moe_route_kernel_reader_on_a_record_by_hand(steps, want,
                                                     monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench.lib import manifest

    read = manifest.load_reader("moe_route_kernel_pct.decode")
    got = read(_decode_record(steps))
    assert got == (None if want is None else pytest.approx(want))
    assert read({"trace": None}) is None
