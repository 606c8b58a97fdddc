"""The typed request/response surface of the synthesis service.

Before this module, a synthesis request travelled the service as a parallel
kwarg tuple — ``(spec, tech=..., resolution=...)`` threaded separately
through ``synthesize``, ``synthesize_many``, ``request_key`` and
``select_macros``, with no place to hang serving-side intent (priority,
deadline).  :class:`SynthesisRequest` is the one value that carries all of
it; every service entry point consumes it and every answer comes back as a
typed response:

  :class:`SynthesisResponse`   a served request: the ``SearchResult``, which
                               tier answered it (``cache`` / ``coalesced`` /
                               ``engine``) and the lifecycle timestamps the
                               async front stamps on it;
  :class:`SheddedResponse`     an explicitly rejected request (queue full,
                               deadline passed, frontend shut down) — load
                               shedding is typed, never a silent drop.

Lifecycle: a request is QUEUED on admission, BATCHED when the scheduler
folds it into a fused engine pass, and ends SERVED or SHEDDED
(:class:`RequestState`).  :class:`StreamEvent` is the streaming unit —
lifecycle transitions plus frontier-so-far partials for long sweeps — fired
on the callbacks a caller registers at submit time.

Requests are frozen and hashable (spec and tech are frozen dataclasses), so
they can key dicts and travel between threads without copying.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from ..core.axes import LatticeConfig
from ..core.macro import MacroSpec
from ..core.searcher import SearchResult
from ..core.tech import TechModel

#: ``SynthesisRequest.kind`` values: ``"search"`` replays Algorithm 1 over
#: the preference grid (the historical request shape); ``"sweep"`` returns
#: the exhaustive design-space frontier — the shape the service answers
#: incrementally from per-axis slice caches when only one axis changed.
REQUEST_KINDS = ("search", "sweep")


class Priority(enum.IntEnum):
    """Admission-queue priority classes (lower value = served first).

    INTERACTIVE is the ``--dcim-select`` shape of traffic — a user waiting
    on one selection; BULK is the 100+-spec sweep shape that can absorb
    batching-window latency.  Ordering within a class is FIFO.
    """

    INTERACTIVE = 0
    BULK = 1


class RequestState(str, enum.Enum):
    """Lifecycle of one request through the async front."""

    QUEUED = "queued"      # admitted, waiting for a batching window
    BATCHED = "batched"    # folded into a fused engine pass
    SERVED = "served"      # answered with a SynthesisResponse
    SHEDDED = "shedded"    # rejected with a SheddedResponse

    def terminal(self) -> bool:
        return self in (RequestState.SERVED, RequestState.SHEDDED)


#: ``SheddedResponse.reason`` values — the complete set, so callers can
#: switch on them.
SHED_REASONS = ("queue_full", "deadline", "shutdown", "internal_error")


@dataclass(frozen=True)
class SynthesisRequest:
    """One synthesis request: what to synthesize plus how to serve it.

    ``tech`` / ``resolution`` / ``mode`` / ``config`` default to the serving
    :class:`~repro_torch.service.service.SynthesisService`'s own defaults when
    ``None`` — the response's cache address always reflects the values the
    request actually ran under.  ``kind`` selects the result shape
    (:data:`REQUEST_KINDS`): a ``"search"`` replays Algorithm 1 over the
    preference grid, a ``"sweep"`` returns the exhaustive lattice frontier
    (and is eligible for incremental re-synthesis from per-axis slice
    caches).  ``config`` picks the lattice axis set
    (:class:`repro_torch.core.axes.LatticeConfig`; the seed axes when unset).
    ``priority`` orders the admission queue; ``deadline_s`` is a relative
    admission deadline (seconds from submit): a request still queued past it
    is shedded, never served stale.
    """

    spec: MacroSpec
    tech: Optional[TechModel] = None
    resolution: Optional[int] = None
    mode: Optional[str] = None
    kind: str = "search"
    config: Optional[LatticeConfig] = None
    priority: Priority = Priority.INTERACTIVE
    deadline_s: Optional[float] = None
    tag: Optional[str] = None        # caller correlation id, echoed back

    def __post_init__(self):
        if not isinstance(self.spec, MacroSpec):
            raise TypeError(f"spec must be a MacroSpec, got "
                            f"{type(self.spec).__name__}")
        if self.kind not in REQUEST_KINDS:
            raise ValueError(f"unknown request kind {self.kind!r}; "
                             f"pick from {REQUEST_KINDS}")
        if self.config is not None and not isinstance(self.config,
                                                      LatticeConfig):
            raise TypeError(f"config must be a LatticeConfig, got "
                            f"{type(self.config).__name__}")
        object.__setattr__(self, "priority", Priority(self.priority))
        if self.resolution is not None and int(self.resolution) < 1:
            raise ValueError("resolution must be >= 1")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError("deadline_s is relative to submit time and "
                             "must be > 0")


@dataclass
class SynthesisResponse:
    """A served request.  ``served_from`` names the tier that answered it:
    ``"cache"`` (FrontierCache hit, memory or disk), ``"coalesced"`` (folded
    onto an identical in-batch miss) or ``"engine"`` (a fused-pass lane).
    The ``*_at`` stamps are :func:`time.monotonic` seconds filled in by the
    async front (``None`` on the direct blocking path)."""

    request: SynthesisRequest
    result: SearchResult
    served_from: str
    state: RequestState = RequestState.SERVED
    queued_at: Optional[float] = None
    batched_at: Optional[float] = None
    served_at: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-served wall latency (the benchmark's p50/p99 metric)."""
        if self.queued_at is None or self.served_at is None:
            return None
        return self.served_at - self.queued_at

    @property
    def queue_delay_s(self) -> Optional[float]:
        """Time spent waiting for a batching window."""
        if self.queued_at is None or self.batched_at is None:
            return None
        return self.batched_at - self.queued_at


@dataclass
class SheddedResponse:
    """An explicitly rejected request — the typed form of load shedding.
    ``reason`` is one of :data:`SHED_REASONS`; ``queue_depth`` is the
    admission-queue depth observed at the shedding decision (the
    backpressure signal a client retries against)."""

    request: SynthesisRequest
    reason: str
    queue_depth: int
    state: RequestState = RequestState.SHEDDED
    detail: str = ""
    result: None = None              # uniform access with SynthesisResponse


@dataclass(frozen=True)
class StreamEvent:
    """One streaming callback unit.

    ``kind`` is a :class:`RequestState` value for lifecycle transitions
    (``queued`` / ``batched`` / ``served`` / ``shedded``) or the string
    ``"frontier"`` for a frontier-so-far partial: ``result`` then carries
    the finished per-spec :class:`SearchResult` and ``done``/``total``
    report sweep progress, so a long lattice sweep streams its frontier as
    each spec lane completes instead of blocking until the last one."""

    request: SynthesisRequest
    kind: str
    index: int = 0
    result: Optional[SearchResult] = None
    response: object = None          # SynthesisResponse | SheddedResponse
    done: int = 0
    total: int = 0


#: ``StreamEvent.kind`` for frontier-so-far partials.
FRONTIER_EVENT = "frontier"


def as_requests(specs, tech=None, resolution=None, mode=None,
                priority: Priority = Priority.INTERACTIVE,
                deadline_s: float | None = None) -> list[SynthesisRequest]:
    """Lift a sequence of bare specs into typed requests with shared
    serving parameters — the helper every deprecation shim builds on."""
    return [SynthesisRequest(spec=s, tech=tech, resolution=resolution,
                             mode=mode, priority=priority,
                             deadline_s=deadline_s) for s in specs]
