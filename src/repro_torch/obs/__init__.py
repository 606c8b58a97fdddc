"""`repro_torch.obs` — tracing + metrics for the serving stack and the
models' serving steps.

Started as a copy of the JAX package's ``repro.obs``, so the port's spans
and counters carry the same names without importing ``repro``.

One subsystem answers "why was this response slow?" end to end:

- :mod:`repro_torch.obs.tracing` — request-scoped spans (trace_id/span_id via
  contextvars, thread-safe across the frontend's scheduler thread) opened
  at frontend admission, per cache tier probed, around the fused engine
  pass (via the engine's own execute/latency hooks — strategies stay
  untouched), at kernel dispatch, and in every serving step
  (``serve.prefill`` / ``serve.decode_step`` roots over the models'
  ``attn``, ``moe.route``, ``moe.experts``, ``mamba`` and ``fake_quant``
  spans).
- :mod:`repro_torch.obs.metrics` — typed counters/histograms with
  fixed-bucket p50/p99; the components' ``telemetry()`` dicts are thin
  views over it (:class:`StatsView`), byte-identical key sets.
- :mod:`repro_torch.obs.export` — Chrome ``trace_event`` timelines
  (``launch.serve --dcim-trace PATH``, Perfetto-loadable).

Spans record in two cases: while :func:`configure` has turned tracing on
(optionally with a sampling rate), and while a ``torch.profiler``
records, where each span used as a context manager is also a
``record_function`` range.  :func:`profiler_ns` places a span on the
profiler's clock.  Otherwise a span costs one flag read and a no-op
``with`` (0.3-0.5 µs on the host of an H100 machine, ``PERF.md``); the
buffer keeps at most ``Tracer.MAX_SPANS`` and counts the rest in
``obs/spans_dropped``.
"""

from __future__ import annotations

from .export import chrome_trace_events, write_chrome_trace
from .metrics import (Counter, Histogram, MetricsRegistry, StatsView,
                      get_registry)
from .tracing import (NOOP_SPAN, Span, SpanContext, SpanHandle, Tracer,
                      profiler_ns, tracer)

__all__ = [
    "Counter", "Histogram", "MetricsRegistry", "StatsView", "get_registry",
    "NOOP_SPAN", "Span", "SpanContext", "SpanHandle", "Tracer", "tracer",
    "chrome_trace_events", "write_chrome_trace",
    "configure", "install_engine_hooks", "uninstall_engine_hooks",
    "profiler_ns",
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
