"""``fake_quant_kernel_pct.decode``: the share of the traced decode steps'
``fake_quant`` spans tagged ``kernel``, read on records built by hand
through ``repro_torch.obs`` (as ``test_perfbench_program_spans`` builds
them), and its manifest entry."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest  # noqa: E402
from repro_torch.obs import tracer  # noqa: E402

NAME = "fake_quant_kernel_pct.decode"
MS = 1_000_000


@pytest.fixture
def clean_tracer():
    clock = tracer.clock
    tracer.clear()
    yield
    tracer.configure(enabled=False, clock=clock)
    tracer.clear()


def _step(i: int, tags: list) -> int:
    """Record decode step ``i``'s root (at 100 i ms on the tracer's clock)
    over a ``fake_quant`` span per entry of ``tags`` (None: untagged), 1
    ms apart; the root's offset to the profiler's clock."""
    base = 0.1 * i
    tracer.configure(enabled=True, clock=lambda: 0.0)
    root = tracer.start_trace("serve.decode_step", start_s=base)
    for j, kernel in enumerate(tags):
        h = tracer.start("fake_quant", parent=root.context,
                         tags={} if kernel is None else {"kernel": kernel},
                         start_s=base + (1 + j) / 1e3)
        h.finish(end_s=base + (1.5 + j) / 1e3)
    root.finish(end_s=base + (2 + len(tags)) / 1e3)
    tracer.configure(enabled=False)
    return root.span.unix_offset_ns


def _record(steps: list) -> dict:
    """A ``--trace 1`` record of one traced decode step per entry of
    ``steps`` (a list of tags each), each step's harness spans around its
    root on the profiler's clock."""
    spans, events = [], []
    for i, tags in enumerate(steps):
        t0 = _step(i, tags) + 100 * i * MS
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
    ([[], []], None)], ids=str)             # no fake_quant span
def test_reader_on_a_record_by_hand(steps, want, clean_tracer):
    got = manifest.load_reader(NAME)(_record(steps))
    assert got == (None if want is None else pytest.approx(want))


def test_reader_reads_nothing_without_a_trace():
    assert manifest.load_reader(NAME)({"trace": None}) is None


def test_manifest_lists_it_in_both_cells():
    m = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}[NAME]
    assert (m["layer"], m["moves"], m["unit"], m["better"]) == (
        "model", "decode_tokens_per_s", "%", "higher")
    assert set(m["workloads"]) == {"granite-moe-3b.decode",
                                   "zamba2-1.2b.decode"}
