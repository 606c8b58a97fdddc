"""`repro_torch.obs` — dependency-free tracing + metrics for the serving stack.

A copy of the JAX package's ``repro.obs`` (stdlib only), so the port's
spans and counters carry the same names without importing ``repro``.

One subsystem answers "why was this response slow?" end to end:

- :mod:`repro_torch.obs.tracing` — request-scoped spans (trace_id/span_id via
  contextvars, thread-safe across the frontend's scheduler thread) opened
  at frontend admission, per cache tier probed, around the fused engine
  pass (via the engine's own execute/latency hooks — strategies stay
  untouched), and at kernel dispatch.
- :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms with
  fixed-bucket p50/p99; the components' ``telemetry()`` dicts are thin
  views over it (:class:`StatsView`), byte-identical key sets.
- :mod:`repro_torch.obs.export` — JSON-lines span log + Chrome ``trace_event``
  timelines (``launch.serve --dcim-trace PATH``, Perfetto-loadable) and
  :func:`metrics_snapshot` text exposition.

Tracing is off by default; :func:`configure` turns it on (optionally with
a sampling rate) and the disabled path is a single contextvar read —
≤1% overhead on ``service/p50_latency_ms``, asserted in CI.
"""

from __future__ import annotations

from .export import (chrome_trace_events, span_dicts, write_chrome_trace,
                     write_spans_jsonl)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, StatsView,
                      get_registry, metrics_snapshot)
from .tracing import NOOP_SPAN, Span, SpanContext, SpanHandle, Tracer, tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "get_registry", "metrics_snapshot",
    "NOOP_SPAN", "Span", "SpanContext", "SpanHandle", "Tracer", "tracer",
    "span_dicts", "write_spans_jsonl", "chrome_trace_events",
    "write_chrome_trace",
    "configure", "install_engine_hooks", "uninstall_engine_hooks",
]


def configure(enabled: bool | None = None, sample: float | None = None,
              clock=None) -> Tracer:
    """Configure the global tracer; enabling also installs the engine
    execute/latency span hooks (idempotent)."""
    tracer.configure(enabled=enabled, sample=sample, clock=clock)
    if tracer.enabled:
        install_engine_hooks()
    return tracer


# -- engine phase spans via the engine's own observation hooks --------------
#
# The execute hook opens an "engine.execute" span as the pass starts; the
# latency hook closes it with the engine's own measured elapsed time.  Spans
# attach to whatever context is current on the executing thread (the
# service activates the engine-pass span around E.execute), so strategies
# and the engine's pipeline stay untouched.

_pending: dict[int, object] = {}
_installed = False


def _on_execute(plan) -> None:
    get_registry().counter("engine/executions").inc()
    if not tracer.enabled:
        return
    span = tracer.start("engine.execute",
                        tags={"mode": plan.placement.mode,
                              "n_specs": len(plan),
                              "n_groups": len(plan.groups),
                              "n_dev": plan.placement.n_dev})
    if span:
        _pending[id(plan)] = span


def _on_latency(plan, elapsed_s: float) -> None:
    get_registry().histogram("engine/pass_latency_s").observe(elapsed_s)
    span = _pending.pop(id(plan), None)
    if span is not None:
        span.finish(end_s=span.span.start_s + elapsed_s)


def install_engine_hooks() -> None:
    """Register the engine execute/latency span hooks (idempotent).
    Imports the engine lazily so ``repro_torch.obs`` itself stays
    stdlib-only."""
    global _installed
    if _installed:
        return
    from ..core import engine
    engine.add_execute_hook(_on_execute)
    engine.add_latency_hook(_on_latency)
    _installed = True


def uninstall_engine_hooks() -> None:
    global _installed
    if not _installed:
        return
    from ..core import engine
    try:
        engine.remove_execute_hook(_on_execute)
    except ValueError:
        pass
    try:
        engine.remove_latency_hook(_on_latency)
    except ValueError:
        pass
    _pending.clear()
    _installed = False
