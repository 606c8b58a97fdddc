"""Request-scoped spans: trace_id/span_id context from frontend to kernels.

A trace is born when a request is admitted (or when a blocking
``SynthesisService.serve`` call starts); every layer underneath — cache
tier probes, the fused engine pass, kernel dispatch — opens child spans
that inherit the trace through a :mod:`contextvars` variable, so the
frontend's scheduler thread and the caller thread each see their own
current span without locks.  Cross-thread handoff is explicit: the
frontend captures each ticket's :class:`SpanContext` at submit time and
re-activates it around the work done on the scheduler thread
(``Tracer.activate``), the same way the response timestamps already
travel on the ``_Entry``.

Tracing is OFF by default.  Disabled (or unsampled) traces take the
:data:`NOOP_SPAN` fast path — one contextvar read and an ``is None``
check, no allocation — which is what keeps the tracing-off overhead on
``service/p50_latency_ms`` under 1% (asserted in CI via
``obs/trace_overhead_pct``).

Span timestamps default to the tracer clock (``time.monotonic``, the
same clock ``SynthesisResponse`` stamps use) but can be passed
explicitly — the frontend does this so the ``request.queued`` /
``request.batched`` span boundaries *equal* the response's
``queued_at``/``batched_at``/``served_at`` rather than approximating
them.

    from repro_torch.obs import tracer
    tracer.configure(enabled=True)
    with tracer.start_trace("request", tags={"key": k}) as root:
        with tracer.span("cache.mem"):
            ...
    spans = tracer.drain()
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
from dataclasses import dataclass, field

from .metrics import get_registry


@dataclass(frozen=True)
class SpanContext:
    """The minimal cross-thread handle: which trace, which parent span."""

    trace_id: str
    span_id: str
    sampled: bool = True


@dataclass
class Span:
    """One finished (or in-flight) span; plain data, exporter-friendly."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_s: float
    end_s: float | None = None
    tags: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return 0.0 if self.end_s is None else self.end_s - self.start_s

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def as_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_s": self.start_s, "end_s": self.end_s,
                "duration_s": self.duration_s,
                "tags": dict(self.tags)}


class _NoopSpan:
    """The disabled-tracing fast path: every operation is a no-op, and it
    nests as a context manager so instrumented code never branches."""

    __slots__ = ()
    context = None
    trace_id = ""
    span_id = ""

    def set_tag(self, key, value):
        return self

    def finish(self, end_s=None):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def __repr__(self):
        return "NOOP_SPAN"


NOOP_SPAN = _NoopSpan()

_current: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "repro_obs_current_span", default=None)


class SpanHandle:
    """A live span: tag it, finish it, or use it as a context manager
    (which also makes it the current span for code underneath)."""

    __slots__ = ("_tracer", "span", "_token")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._token = None

    @property
    def context(self) -> SpanContext:
        return self.span.context

    @property
    def trace_id(self) -> str:
        return self.span.trace_id

    @property
    def span_id(self) -> str:
        return self.span.span_id

    def set_tag(self, key: str, value) -> "SpanHandle":
        self.span.tags[key] = value
        return self

    def finish(self, end_s: float | None = None) -> Span:
        if self.span.end_s is None:
            self.span.end_s = (self._tracer.clock()
                               if end_s is None else end_s)
            self._tracer._record(self.span)
        return self.span

    def __enter__(self) -> "SpanHandle":
        self._token = _current.set(self.span.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None and "error" not in self.span.tags:
            self.set_tag("error", exc_type.__name__)
        self.finish()
        return False

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        state = "open" if self.span.end_s is None else "finished"
        return f"SpanHandle({self.span.name}, {state})"


class Tracer:
    """Collects spans into a bounded in-memory buffer.

    ``enabled=False`` (the default) short-circuits every entry point to
    :data:`NOOP_SPAN`.  ``sample`` in (0, 1] applies at *trace-root*
    creation only — a trace is either fully recorded or fully noop, so
    exported timelines never have orphan children."""

    MAX_SPANS = 100_000   # drop (and count) beyond this, never grow unbounded

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._enabled = False
        self._sample = 1.0
        self._rng = random.Random(0xD01)
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._counter = 0

    # -- configuration ----------------------------------------------------

    def configure(self, enabled: bool | None = None,
                  sample: float | None = None,
                  clock=None) -> "Tracer":
        if enabled is not None:
            self._enabled = bool(enabled)
        if sample is not None:
            if not 0.0 < sample <= 1.0:
                raise ValueError(f"sample rate must be in (0, 1], got "
                                 f"{sample}")
            self._sample = float(sample)
        if clock is not None:
            self.clock = clock
        return self

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def sample_rate(self) -> float:
        return self._sample

    # -- ids ---------------------------------------------------------------

    def _new_id(self) -> str:
        with self._lock:
            self._counter += 1
            n = self._counter
        return f"{n:08x}{self._rng.getrandbits(32):08x}"

    # -- span creation -----------------------------------------------------

    def current(self) -> SpanContext | None:
        """The context-local current span, if any."""
        return _current.get()

    def start_trace(self, name: str, tags: dict | None = None,
                    start_s: float | None = None):
        """Open a trace root.  Applies sampling; returns NOOP_SPAN when
        disabled or the trace is not sampled."""
        if not self._enabled:
            return NOOP_SPAN
        if self._sample < 1.0 and self._rng.random() >= self._sample:
            get_registry().counter("obs/traces_unsampled").inc()
            return NOOP_SPAN
        get_registry().counter("obs/traces_started").inc()
        tid = self._new_id()
        span = Span(name=name, trace_id=tid, span_id=self._new_id(),
                    parent_id=None,
                    start_s=self.clock() if start_s is None else start_s,
                    tags=dict(tags or {}))
        return SpanHandle(self, span)

    def start(self, name: str, parent: SpanContext | None = None,
              tags: dict | None = None, start_s: float | None = None):
        """Open a child span under ``parent`` (default: the context-local
        current span).  NOOP when disabled or there is no live parent —
        children never start orphan traces of their own."""
        if not self._enabled:
            return NOOP_SPAN
        if parent is None:
            parent = _current.get()
        if parent is None:
            return NOOP_SPAN
        span = Span(name=name, trace_id=parent.trace_id,
                    span_id=self._new_id(), parent_id=parent.span_id,
                    start_s=self.clock() if start_s is None else start_s,
                    tags=dict(tags or {}))
        return SpanHandle(self, span)

    def span(self, name: str, parent: SpanContext | None = None,
             tags: dict | None = None):
        """Alias for :meth:`start` — reads as a context manager."""
        return self.start(name, parent=parent, tags=tags)

    @contextlib.contextmanager
    def activate(self, ctx: SpanContext | None):
        """Make ``ctx`` the context-local current span for a block — the
        cross-thread handoff primitive (scheduler thread re-activating a
        ticket's context).  ``None`` deactivates (no current span)."""
        token = _current.set(ctx)
        try:
            yield ctx
        finally:
            _current.reset(token)

    # -- collection --------------------------------------------------------

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.MAX_SPANS:
                get_registry().counter("obs/spans_dropped").inc()
                return
            self._spans.append(span)
        get_registry().counter("obs/spans_finished").inc()

    def spans(self) -> list[Span]:
        """Snapshot of finished spans (oldest first)."""
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[Span]:
        """Return finished spans and clear the buffer."""
        with self._lock:
            out = self._spans
            self._spans = []
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans = []


#: The process-global tracer every instrumented layer talks to.
tracer = Tracer()
