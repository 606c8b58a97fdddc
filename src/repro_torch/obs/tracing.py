"""Request-scoped spans: trace_id/span_id context from frontend to kernels.

A trace is born when a request is admitted (or when a blocking
``SynthesisService.serve`` call starts, or a serving step runs:
``serve.prefill`` / ``serve.decode_step``); every layer underneath — cache
tier probes, the fused engine pass, kernel dispatch, and the models'
``attn``, ``moe.route``, ``moe.experts``, ``mamba`` and ``fake_quant``
blocks — opens child spans that inherit the trace through a
:mod:`contextvars` variable, so the frontend's scheduler thread and the
caller thread each see their own current span without locks.
Cross-thread handoff is explicit: the frontend captures each ticket's
:class:`SpanContext` at submit time and re-activates it around the work
done on the scheduler thread (``Tracer.activate``), the same way the
response timestamps already travel on the ``_Entry``.

Spans record while tracing is configured on (``Tracer.configure(
enabled=True)``, as ``launch.serve --dcim-trace`` does) or while a
``torch.profiler`` is recording.  Under a recording profiler every span
used as a context manager is also a ``record_function`` range of the
same name, so the profiler's trace shows it beside the device's
operations.  Otherwise every entry point returns :data:`NOOP_SPAN`: one
flag read, an ``is None`` check and the no-op's ``with``, with no
allocation, no string formatting and no ``record_function`` call.  That
costs 0.3-0.5 µs per span on the host of an H100 machine (``PERF.md``).

Span timestamps default to the tracer clock (``time.monotonic``, the
same clock ``SynthesisResponse`` stamps use) but can be passed
explicitly — the frontend does this so the ``request.queued`` /
``request.batched`` span boundaries *equal* the response's
``queued_at``/``batched_at``/``served_at`` rather than approximating
them.  Each trace root samples the offset from that clock to the Unix
clock ``torch.profiler`` stamps its events with, and its spans carry it:
:func:`profiler_ns` places a span on the profiler's timeline.

A tag may hold a device scalar (a 0-d tensor), so that a count is taken
without synchronising the step; the buffer's readers (:meth:`Tracer.spans`,
:meth:`Tracer.drain`) resolve it to a Python number.

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

from torch.autograd import profiler as _profiler

from .metrics import get_registry


@dataclass(frozen=True)
class SpanContext:
    """The minimal cross-thread handle: which trace, which parent span."""

    trace_id: str
    span_id: str
    sampled: bool = True
    unix_offset_ns: int = 0


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
    unix_offset_ns: int = 0     # Unix ns less tracer-clock ns, at the root

    @property
    def duration_s(self) -> float:
        return 0.0 if self.end_s is None else self.end_s - self.start_s

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id,
                           unix_offset_ns=self.unix_offset_ns)

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

    def __exit__(self, exc_type, exc, tb):
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
    (which also makes it the current span for code underneath, and a
    ``record_function`` range while a profiler records)."""

    __slots__ = ("_tracer", "span", "_token", "_range", "_own_start")

    def __init__(self, tracer: "Tracer", span: Span,
                 own_start: bool = False):
        self._tracer = tracer
        self.span = span
        self._token = None
        self._range = None
        self._own_start = own_start     # the tracer stamped its start

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
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.span.name)
            self._range.__enter__()
            if self._own_start:
                # start with the range, not before the range's set-up
                self.span.start_s = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_s = None
        if self._range is not None:
            # the range stamps its end partway through closing: take the
            # middle of the close
            before = self._tracer.clock()
            self._range.__exit__(None, None, None)
            self._range = None
            end_s = (before + self._tracer.clock()) / 2
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None and "error" not in self.span.tags:
            self.set_tag("error", exc_type.__name__)
        self.finish(end_s)
        return False

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        state = "open" if self.span.end_s is None else "finished"
        return f"SpanHandle({self.span.name}, {state})"


class Tracer:
    """Collects spans into a bounded in-memory buffer.

    With ``enabled=False`` (the default) and no profiler recording, every
    entry point short-circuits to :data:`NOOP_SPAN`.  ``sample`` in (0, 1]
    applies at *trace-root* creation only — a trace is either fully
    recorded or fully noop, so exported timelines never have orphan
    children."""

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
        off (module doc) or the trace is not sampled."""
        if not (self._enabled or _profiler._is_profiler_enabled):
            return NOOP_SPAN
        if self._sample < 1.0 and self._rng.random() >= self._sample:
            return NOOP_SPAN
        tid = self._new_id()
        before = time.time_ns()
        now = self.clock()
        offset = (before + time.time_ns()) // 2 - round(now * 1e9)
        span = Span(name=name, trace_id=tid, span_id=self._new_id(),
                    parent_id=None,
                    start_s=now if start_s is None else start_s,
                    tags=dict(tags or {}), unix_offset_ns=offset)
        return SpanHandle(self, span, own_start=start_s is None)

    def start(self, name: str, parent: SpanContext | None = None,
              tags: dict | None = None, start_s: float | None = None):
        """Open a child span under ``parent`` (default: the context-local
        current span).  NOOP when off (module doc) or there is no live
        parent — children never start orphan traces of their own."""
        if not (self._enabled or _profiler._is_profiler_enabled):
            return NOOP_SPAN
        if parent is None:
            parent = _current.get()
        if parent is None:
            return NOOP_SPAN
        span = Span(name=name, trace_id=parent.trace_id,
                    span_id=self._new_id(), parent_id=parent.span_id,
                    start_s=self.clock() if start_s is None else start_s,
                    tags=dict(tags or {}),
                    unix_offset_ns=parent.unix_offset_ns)
        return SpanHandle(self, span, own_start=start_s is None)

    #: :meth:`start` under the name that reads as a context manager
    span = start

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

    def spans(self) -> list[Span]:
        """Snapshot of finished spans (oldest first), their deferred tags
        resolved (module doc)."""
        with self._lock:
            out = list(self._spans)
        return _resolved(out)

    def drain(self) -> list[Span]:
        """Return finished spans, their deferred tags resolved, and clear
        the buffer."""
        with self._lock:
            out = self._spans
            self._spans = []
        return _resolved(out)

    def clear(self) -> None:
        with self._lock:
            self._spans = []


def _resolved(spans: list[Span]) -> list[Span]:
    """``spans``, each tag that holds a device scalar replaced in place by
    its Python number (this waits for the device)."""
    for s in spans:
        for key, value in s.tags.items():
            item = getattr(value, "item", None)
            if item is not None:
                s.tags[key] = item()
    return spans


def profiler_ns(span: Span) -> tuple[int, int]:
    """``span``'s start and end on ``torch.profiler``'s clock (Unix-epoch
    nanoseconds, as its events' ``start_ns()``); an open span ends where it
    starts."""
    end_s = span.start_s if span.end_s is None else span.end_s
    return (round(span.start_s * 1e9) + span.unix_offset_ns,
            round(end_s * 1e9) + span.unix_offset_ns)


#: The process-global tracer every instrumented layer talks to.
tracer = Tracer()
