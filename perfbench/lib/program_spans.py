"""The program's own spans in the traced decode steps of a ``--trace 1``
run, and the per-layer metrics read from them.

While the run's profiler records, the port records its serving steps'
spans (``repro_torch.obs``): a ``serve.decode_step`` root per decode call
over the model's ``attn``, ``moe.route`` (tagged ``routed``, ``slots``
and ``kept``), ``moe.experts``, ``mamba`` and ``fake_quant`` spans.  They
are read here through ``obs``'s public API, never drained, and put on
the profiler's clock (``obs.profiler_ns``).  Each traced decode step (the
harness's ``decode_call`` span in ``rec["trace"]``) keeps the one root
that lies inside it, with that root's trace: spans are picked by time, so
spans of earlier runs in the same process are never read.

Every reading is None where a traced decode step has no root (a program
without these spans), where no span of the layer was found, or where the
buffer dropped spans (``obs/spans_dropped`` above 0): never a partial sum.
"""

from __future__ import annotations

from perfbench.lib.trace import steps_of, union_ns


def decode_steps(rec) -> list | None:
    """``[(t0, t1, ops, spans)]`` per traced decode step: its extent and
    device ops (:func:`perfbench.lib.trace.steps_of`) and its program
    spans ``[(name, start_ns, end_ns, tags)]``, the root first; None as
    the module doc says."""
    tr = rec.get("trace")
    if not tr:
        return None
    try:
        from repro_torch.obs import get_registry, profiler_ns, tracer
    except ImportError:
        return None
    if get_registry().value("obs/spans_dropped"):
        return None
    by_trace: dict[str, list] = {}
    roots = []
    for sp in tracer.spans():
        s, e = profiler_ns(sp)
        by_trace.setdefault(sp.trace_id, []).append((sp.name, s, e, sp.tags))
        if sp.name == "serve.decode_step" and sp.parent_id is None:
            roots.append((s, e, sp.trace_id))
    out = []
    for i, (ev, t0, t1, ops) in enumerate(steps_of(tr)):
        if ev["kind"] != "decode":
            continue
        _, c0, c1 = tr["spans"][3 * i]            # the step's decode_call
        inside = [tid for s, e, tid in roots if c0 <= (s + e) // 2 < c1]
        if len(inside) != 1:
            return None
        spans = sorted(by_trace[inside[0]],
                       key=lambda sp: sp[0] != "serve.decode_step")
        out.append((t0, t1, ops, spans))
    return out or None


def _of(spans, name) -> list:
    return [(s, e) for n, s, e, _ in spans if n == name]


def _steps_with(rec, name: str) -> list | None:
    """:func:`decode_steps`, or None where no step has a ``name`` span."""
    steps = decode_steps(rec)
    if steps is None or not any(_of(sp, name) for *_, sp in steps):
        return None
    return steps


def host_ms(rec, name: str) -> float | None:
    """The summed duration of a traced decode step's ``name`` spans,
    mean over the steps, in ms."""
    steps = _steps_with(rec, name)
    if steps is None:
        return None
    return sum(sum(e - s for s, e in _of(sp, name))
               for *_, sp in steps) / len(steps) / 1e6


def idle_ms(rec, name: str) -> float | None:
    """The device-idle time of a traced decode step (its extent less the
    union of its device ops) that falls inside the union of its ``name``
    spans, mean over the steps, in ms."""
    steps = _steps_with(rec, name)
    if steps is None:
        return None
    total = 0
    for t0, t1, ops, sp in steps:
        busy = [(s, e) for _, s, e, _ in ops]
        # idle inside the spans = |spans ∪ busy| - |busy|
        total += union_ns(busy + _of(sp, name), t0, t1) \
            - union_ns(busy, t0, t1)
    return total / len(steps) / 1e6


def moe_counts(rec) -> tuple[int, int, int] | None:
    """``(routed, slots, kept)`` summed over the traced decode steps'
    ``moe.route`` spans."""
    steps = decode_steps(rec)
    tags = [t for *_, sp in (steps or []) for n, _, _, t in sp
            if n == "moe.route"]
    if not tags:
        return None
    return tuple(int(sum(t[k] for t in tags))
                 for k in ("routed", "slots", "kept"))
