"""The async/streaming synthesis front: admission queue, priority classes,
batching window, backpressure, and streamed partial results.

:class:`SynthesisService` (one layer down) is a blocking batch call — the
caller must already hold a batch to get fusion.  This module is the piece
that *builds* those batches from an online request stream, the
continuous-batching serving idiom applied to synthesis requests:

  admission   ``submit`` pushes a typed request onto a **bounded** priority
              queue (INTERACTIVE ahead of BULK, FIFO within a class).  A
              full queue sheds the request immediately with a typed
              :class:`~repro_torch.service.requests.SheddedResponse` (reason
              ``queue_full``) — backpressure is explicit, never a timeout
              and never a silent drop;
  window      the scheduler collects requests for a batching window (until
              ``max_batch`` requests are waiting or ``window`` seconds
              elapse since the first one), then drains the queue in
              priority order;
  fused pass  the drained batch goes through ``service.serve`` — the
              cache / coalesce / ONE-``engine.execute`` tiers of the service — so
              concurrency raises fusion instead of contention.  The window
              *adapts*: the engine's latency hooks
              (:func:`repro_torch.core.engine.add_latency_hook`) feed observed
              per-pass latency back, and the window tracks a fraction of it
              (clamped), so a slow engine grows batches instead of queues;
  stream      every lifecycle transition (queued → batched → served /
              shedded) and every finished spec lane fires
              :class:`~repro_torch.service.requests.StreamEvent` callbacks — a
              long lattice sweep streams its frontier-so-far
              (:meth:`ServiceFrontend.submit_sweep`) while later lanes are
              still computing.

Results are bit-identical to the blocking path in every tier: the frontend
adds scheduling, not arithmetic — a drained batch is served by exactly the
``synthesize_many`` machinery the differential harness pins.

    from repro_torch.service import ServiceFrontend, SynthesisRequest
    with ServiceFrontend() as front:
        t = front.submit(SynthesisRequest(spec=spec))
        resp = t.result(timeout=60)          # SynthesisResponse | Shedded
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Optional, Sequence

from ..core import engine as E
from ..core.macro import MacroSpec
from ..obs import tracer
from ..obs.metrics import StatsView, get_registry
from .requests import (FRONTIER_EVENT, Priority, RequestState,
                       SheddedResponse, StreamEvent, SynthesisRequest,
                       SynthesisResponse)
from .service import SynthesisService

#: Bounds the adaptive batching window (seconds): the window never shrinks
#: below the floor (pure dispatch jitter) nor grows past the ceiling (an
#: interactive request never waits longer than this for co-batching).
WINDOW_BOUNDS = (0.001, 0.25)

#: The adaptive window targets this fraction of the observed fused-pass
#: latency — batching overhead stays a bounded tax on what the engine
#: already costs.
WINDOW_FRACTION = 0.1


class FrontendStats(StatsView):
    """Admission-queue counters, backed by a metrics registry
    (:class:`repro_torch.obs.metrics.StatsView` — same attributes and
    ``as_dict()`` key set as the historical dataclass).

    - ``submitted``: admitted to the queue
    - ``shedded``: typed rejections (all reasons)
    - ``batches``: scheduler drains that reached the service
    - ``max_batch``: largest drained batch
    - ``depth_hwm``: admission-queue depth high-water mark
    """

    _NAMESPACE = "frontend"
    _FIELDS = ("submitted", "served", "shedded", "batches", "max_batch",
               "depth_hwm")


class Ticket:
    """The caller's handle on one submitted request: blocks on
    :meth:`result` until the terminal response (served or shedded) exists.
    """

    def __init__(self, request: SynthesisRequest):
        self.request = request
        self._done = threading.Event()
        self._response: SynthesisResponse | SheddedResponse | None = None
        self.state = RequestState.QUEUED

    def _resolve(self, response) -> None:
        self._response = response
        self.state = response.state
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None
               ) -> SynthesisResponse | SheddedResponse:
        """The terminal response.  Raises ``TimeoutError`` if it does not
        arrive in ``timeout`` seconds (the request stays in flight)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s "
                               f"(state={self.state.value})")
        return self._response


class _Entry:
    """One queued request plus its scheduling state."""

    __slots__ = ("request", "ticket", "on_event", "submitted_at",
                 "deadline_at", "batched_at", "span")

    def __init__(self, request, ticket, on_event, submitted_at, deadline_at,
                 span=None):
        self.request = request
        self.ticket = ticket
        self.on_event = on_event
        self.submitted_at = submitted_at
        self.deadline_at = deadline_at
        self.batched_at = None
        self.span = span        # the request's trace root (SpanHandle|noop)


class SweepHandle:
    """Handle on a bulk multi-spec sweep: collects the per-spec tickets and
    streams the pooled frontier-so-far as lanes complete."""

    def __init__(self, tickets: list[Ticket]):
        self.tickets = tickets
        self.total = len(tickets)

    def results(self, timeout: float | None = None
                ) -> list[SynthesisResponse | SheddedResponse]:
        """All terminal responses, in submission order."""
        return [t.result(timeout) for t in self.tickets]


class ServiceFrontend:
    """The admission queue + scheduler over one :class:`SynthesisService`.

    ``window`` seconds is the base batching window; with
    ``adaptive_window`` (default) it tracks :data:`WINDOW_FRACTION` of the
    engine's observed per-pass latency within :data:`WINDOW_BOUNDS`.
    ``max_batch`` caps one drain; ``max_depth`` bounds the admission queue —
    the backpressure limit past which submits are shed.  ``start=False``
    skips the scheduler thread; tests then drive batches deterministically
    with :meth:`run_pending`.
    """

    def __init__(self, service: SynthesisService | None = None, *,
                 window: float = 0.005, max_batch: int = 32,
                 max_depth: int = 128, adaptive_window: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        if max_batch < 1 or max_depth < 1:
            raise ValueError("max_batch and max_depth must be >= 1")
        self.service = service if service is not None else SynthesisService()
        self.window = float(window)
        self.max_batch = int(max_batch)
        self.max_depth = int(max_depth)
        self.adaptive_window = bool(adaptive_window)
        self.stats = FrontendStats()
        self._clock = clock
        self._heap: list[tuple[int, int, _Entry]] = []
        self._seq = 0
        self._inflight = 0               # batches currently being served
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._stopping = False
        self._pass_latency_ewma: float | None = None
        E.add_latency_hook(self._observe_pass)
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(target=self._loop,
                                            name="synthesis-frontend",
                                            daemon=True)
            self._thread.start()

    # -- admission -----------------------------------------------------------

    def submit(self, request: SynthesisRequest,
               on_event: Optional[Callable[[StreamEvent], None]] = None
               ) -> Ticket:
        """Admit one request.  Returns immediately with a :class:`Ticket`;
        if the queue is full (or the frontend is shutting down) the ticket
        is already resolved with a typed :class:`SheddedResponse` — the
        caller always learns the fate of every request."""
        if not isinstance(request, SynthesisRequest):
            raise TypeError("submit() takes a SynthesisRequest, got "
                            f"{type(request).__name__}")
        ticket = Ticket(request)
        now = self._clock()
        span = tracer.start_trace("request", start_s=now, tags={
            "kind": request.kind, "priority": int(request.priority)})
        if span and request.tag is not None:
            span.set_tag("tag", request.tag)
        with self._work:
            depth = len(self._heap)
            reason = None
            if self._stopping:
                reason = "shutdown"
            elif depth >= self.max_depth:
                reason = "queue_full"
            if reason is not None:
                self.stats.shedded += 1
                resp = SheddedResponse(request=request, reason=reason,
                                       queue_depth=depth)
                ticket._resolve(resp)
                if span:
                    span.set_tag("shedded", reason)
                    span.finish(end_s=self._clock())
                self._emit(on_event, StreamEvent(
                    request=request, kind=RequestState.SHEDDED.value,
                    response=resp))
                return ticket
            entry = _Entry(request, ticket, on_event, now,
                           None if request.deadline_s is None
                           else now + request.deadline_s, span=span)
            heapq.heappush(self._heap,
                           (int(request.priority), self._seq, entry))
            self._seq += 1
            self.stats.submitted += 1
            self.stats.depth_hwm = max(self.stats.depth_hwm,
                                       len(self._heap))
            self._emit(on_event, StreamEvent(
                request=request, kind=RequestState.QUEUED.value))
            self._work.notify_all()
        return ticket

    def submit_sweep(self, specs: Sequence[MacroSpec], *, tech=None,
                     resolution=None, mode=None,
                     priority: Priority = Priority.BULK,
                     on_frontier: Optional[Callable[[int, int, tuple],
                                                    None]] = None
                     ) -> SweepHandle:
        """Submit a long lattice sweep as one bulk request per spec and
        stream the pooled frontier-so-far: ``on_frontier(done, total,
        pool)`` fires each time a lane completes, with ``pool`` the
        eps-nondominated union over every finished lane (the same
        ``frontier_union`` the offline sweeps end with) — so a caller
        watches the sweep's frontier grow instead of blocking on the last
        spec."""
        specs = list(specs)
        done: list = []
        stream_lock = threading.Lock()

        def lane_event(ev: StreamEvent) -> None:
            if ev.kind != FRONTIER_EVENT or on_frontier is None:
                return
            from ..core.multispec import frontier_union
            with stream_lock:
                done.append(ev.result)
                pool, _ = frontier_union(
                    done, [f"sweep[{i}]" for i in range(len(done))])
                on_frontier(len(done), len(specs), tuple(pool))

        tickets = [self.submit(SynthesisRequest(
            spec=s, tech=tech, resolution=resolution, mode=mode,
            priority=priority), on_event=lane_event) for s in specs]
        return SweepHandle(tickets)

    def serve(self, requests: Sequence[SynthesisRequest],
              timeout: float | None = None) -> list[SynthesisResponse]:
        """Blocking convenience: submit every request, wait for all of
        them.  Raises ``RuntimeError`` if any was shedded (callers that
        want typed sheds use :meth:`submit` directly) — so this method has
        the same all-or-nothing contract as ``SynthesisService.serve`` and
        ``select_macros`` can run through a frontend unchanged."""
        tickets = [self.submit(r) for r in requests]
        out = []
        for t in tickets:
            resp = t.result(timeout)
            if isinstance(resp, SheddedResponse):
                raise RuntimeError(
                    f"request shedded ({resp.reason}, queue_depth="
                    f"{resp.queue_depth}); retry with backoff or raise "
                    "max_depth")
            out.append(resp)
        return out

    # -- the batching window -------------------------------------------------

    def effective_window(self) -> float:
        """The batching window currently in force: the base window, or —
        once the engine's latency hooks have reported fused-pass times —
        :data:`WINDOW_FRACTION` of the latency EWMA, clamped to
        :data:`WINDOW_BOUNDS`."""
        if not self.adaptive_window or self._pass_latency_ewma is None:
            return self.window
        lo, hi = WINDOW_BOUNDS
        return min(max(self._pass_latency_ewma * WINDOW_FRACTION, lo,
                       self.window), hi)

    def _observe_pass(self, plan, elapsed_s: float) -> None:
        """Engine latency hook: feed per-pass latency back to the window."""
        with self._lock:
            if self._pass_latency_ewma is None:
                self._pass_latency_ewma = elapsed_s
            else:
                self._pass_latency_ewma = (0.7 * self._pass_latency_ewma
                                           + 0.3 * elapsed_s)

    # -- the scheduler -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._serve_batch(batch)
            with self._work:
                self._inflight -= 1
                if not self._heap and self._inflight == 0:
                    self._idle.notify_all()

    def _collect(self) -> list[_Entry] | None:
        """Block until work exists, hold the batching window open, then
        drain up to ``max_batch`` entries in (priority, FIFO) order."""
        with self._work:
            while not self._heap and not self._stopping:
                self._work.wait()
            if not self._heap:
                return None                      # stopping and drained
            deadline = self._clock() + self.effective_window()
            while (len(self._heap) < self.max_batch
                   and not self._stopping):
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                self._work.wait(remaining)
            batch = self._pop_batch_locked()
            self._inflight += 1
            return batch

    def _pop_batch_locked(self) -> list[_Entry]:
        batch = []
        while self._heap and len(batch) < self.max_batch:
            _, _, entry = heapq.heappop(self._heap)
            batch.append(entry)
        return batch

    def run_pending(self) -> int:
        """Drain and serve one batch synchronously on the calling thread —
        the deterministic drive the tests and single-threaded callers use
        (no scheduler races: submissions already queued are batched in
        strict priority order).  Returns the number of requests served or
        shedded; 0 when the queue is empty."""
        with self._work:
            batch = self._pop_batch_locked()
        if not batch:
            return 0
        self._serve_batch(batch)
        return len(batch)

    def _serve_batch(self, batch: list[_Entry]) -> None:
        now = self._clock()
        live: list[_Entry] = []
        for e in batch:
            if e.deadline_at is not None and now > e.deadline_at:
                self.stats.shedded += 1
                resp = SheddedResponse(request=e.request, reason="deadline",
                                       queue_depth=len(self._heap))
                resp_ev = StreamEvent(request=e.request,
                                      kind=RequestState.SHEDDED.value,
                                      response=resp)
                e.ticket._resolve(resp)
                if e.span:
                    e.span.set_tag("shedded", "deadline")
                    e.span.finish(end_s=now)
                self._emit(e.on_event, resp_ev)
                continue
            e.batched_at = now
            e.ticket.state = RequestState.BATCHED
            self._emit(e.on_event, StreamEvent(
                request=e.request, kind=RequestState.BATCHED.value))
            live.append(e)
        if not live:
            return
        self.stats.batches += 1
        self.stats.max_batch = max(self.stats.max_batch, len(live))

        def partial(i: int, result) -> None:
            e = live[i]
            self._emit(e.on_event, StreamEvent(
                request=e.request, kind=FRONTIER_EVENT, index=i,
                result=result, done=i + 1, total=len(live)))

        try:
            responses = self.service.serve(
                [e.request for e in live], on_partial=partial,
                contexts=[e.span.context if e.span else None for e in live])
        except Exception as exc:                     # typed, never silent
            with self._lock:
                depth = len(self._heap)
            for e in live:
                self.stats.shedded += 1
                resp = SheddedResponse(request=e.request,
                                       reason="internal_error",
                                       queue_depth=depth,
                                       detail=f"{type(exc).__name__}: {exc}")
                e.ticket._resolve(resp)
                if e.span:
                    e.span.set_tag("error", type(exc).__name__)
                    e.span.finish(end_s=self._clock())
                self._emit(e.on_event, StreamEvent(
                    request=e.request, kind=RequestState.SHEDDED.value,
                    response=resp))
            return
        served_at = self._clock()
        latency = get_registry().histogram("frontend/request_latency_s")
        for e, resp in zip(live, responses):
            resp.queued_at = e.submitted_at
            resp.batched_at = e.batched_at
            resp.served_at = served_at
            self.stats.served += 1
            latency.observe(served_at - e.submitted_at)
            if e.span:
                # Lifecycle children carry the very timestamps the response
                # is stamped with, so span boundaries == response times.
                tracer.start("request.queued", parent=e.span.context,
                             start_s=e.submitted_at
                             ).finish(end_s=e.batched_at)
                tracer.start("request.batched", parent=e.span.context,
                             start_s=e.batched_at,
                             tags={"batch_size": len(live)}
                             ).finish(end_s=served_at)
                e.span.set_tag("served_from", resp.served_from)
                e.span.finish(end_s=served_at)
            e.ticket._resolve(resp)
            self._emit(e.on_event, StreamEvent(
                request=e.request, kind=RequestState.SERVED.value,
                response=resp))

    @staticmethod
    def _emit(on_event, event: StreamEvent) -> None:
        if on_event is None:
            return
        try:
            on_event(event)
        except Exception:
            pass          # a broken observer must not take down the front

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: float | None = None) -> bool:
        """Block until the queue is empty and no batch is in flight."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._idle:
            while self._heap or self._inflight:
                remaining = (None if deadline is None
                             else deadline - self._clock())
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def close(self, drain: bool = True) -> None:
        """Stop the scheduler.  With ``drain`` (default) queued requests
        are served first; otherwise they are shed with reason
        ``shutdown``.  Idempotent; also removes the engine latency hook."""
        with self._work:
            self._stopping = True
            if not drain:
                leftovers = self._pop_batch_locked()
                while leftovers:
                    for e in leftovers:
                        self.stats.shedded += 1
                        resp = SheddedResponse(request=e.request,
                                               reason="shutdown",
                                               queue_depth=0)
                        e.ticket._resolve(resp)
                        self._emit(e.on_event, StreamEvent(
                            request=e.request,
                            kind=RequestState.SHEDDED.value, response=resp))
                    leftovers = self._pop_batch_locked()
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        elif drain:
            while self.run_pending():
                pass
        try:
            E.remove_latency_hook(self._observe_pass)
        except ValueError:
            pass          # already removed (double close)

    def __enter__(self) -> "ServiceFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def depth(self) -> int:
        """Current admission-queue depth (the backpressure observable)."""
        with self._lock:
            return len(self._heap)

    def telemetry(self) -> dict:
        """The full serving-stack stats rollup: the service's request /
        cache / shared-registry counters (:meth:`SynthesisService.
        telemetry`) plus this front's admission-queue counters — the one
        dict a fleet dashboard scrapes per host."""
        out = self.service.telemetry()
        out["frontend"] = self.stats.as_dict()
        return out
