"""Typed metrics for the serving stack: counters, gauges, histograms.

One :class:`MetricsRegistry` is the single source of truth for every
counter the stack reports.  The per-component stats objects the earlier
PRs grew (``ServiceStats``, ``CacheStats``, ``RegistryStats``,
``FrontendStats``) are now :class:`StatsView` subclasses — their integer
attributes are *views over registry counters*, so ``stats.requests += 1``
keeps working at every historical call site while the value itself lives
in a registry that exporters and dashboards can walk.  The components'
``telemetry()`` dicts therefore keep byte-identical key sets (snapshot
tested) while delegating to the registry.

Histograms use fixed log-spaced buckets so p50/p99 latency quantiles come
out of pure-python bucket interpolation — no numpy on the hot path, and a
bounded memory footprint regardless of sample count.

Everything here is stdlib-only and thread-safe (one lock per metric; the
increments themselves are as racy as the plain-int fields they replace,
which is to say: not, under the GIL's read-modify-write granularity for
the purposes these counters serve).

    from repro_torch.obs import get_registry, metrics_snapshot
    get_registry().counter("kernel/dcim_mac/dispatch").inc()
    print(metrics_snapshot())
"""

from __future__ import annotations

import threading
import weakref

#: Default histogram bucket upper bounds (seconds): log-spaced 1-2-5 decades
#: from 1 µs to 60 s — wide enough for span durations from a cache probe to
#: a cold exhaustive sweep, and fixed so quantiles never allocate.
DEFAULT_BUCKETS = (
    1e-6, 2e-6, 5e-6, 1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4,
    1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 0.1, 0.2, 0.5,
    1.0, 2.0, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """A monotonic integer counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, value: int) -> None:
        """Direct assignment — the escape hatch :class:`StatsView` field
        writes (``stats.x += 1`` desugars to get-then-set) resolve to."""
        with self._lock:
            self._value = int(value)

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Gauge:
    """A point-in-time float value (queue depth, window size, fraction)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    ``observe(v)`` is O(len(buckets)) worst case (a linear scan over ~24
    bounds — no allocation, no numpy); quantiles linearly interpolate
    inside the bucket where the requested rank falls, which is exact
    enough for p50/p99 latency tracking and never touches the samples
    themselves (none are kept)."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, name: str, bounds: tuple[float, ...] | None = None):
        self.name = name
        self.bounds = tuple(float(b) for b in (bounds or DEFAULT_BUCKETS))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bucket bounds must be sorted")
        self._counts = [0] * (len(self.bounds) + 1)   # +1: overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    break
            else:
                i = len(self.bounds)
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Interpolated quantile estimate (0 <= q <= 1); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q * self._count
            seen = 0
            for i, n in enumerate(self._counts):
                if n == 0:
                    continue
                if seen + n >= rank:
                    lo = 0.0 if i == 0 else self.bounds[i - 1]
                    hi = (self._max if i == len(self.bounds)
                          else self.bounds[i])
                    lo = max(lo, self._min) if i == 0 else lo
                    frac = (rank - seen) / n
                    return min(lo + (hi - lo) * frac, self._max)
                seen += n
            return self._max

    def summary(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
        return {"count": self._count, "sum": self._sum,
                "min": self._min, "max": self._max,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}

    def __repr__(self) -> str:
        return f"Histogram({self.name}, n={self._count})"


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    A registry is cheap; every component stats object owns one (so two
    services in one process never share counters — the per-instance
    semantics the existing tests pin), and all registries are enumerable
    through :func:`metrics_snapshot` for the process-wide exposition."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        _COMPONENTS.add(self)

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        return self._get_or_create(name, Histogram, bounds)

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str):
        m = self._metrics.get(name)
        return None if m is None else m.value

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def as_dict(self) -> dict:
        """{name: value | histogram summary} snapshot of this registry."""
        out = {}
        for name in self.names():
            m = self._metrics[name]
            out[name] = (m.summary() if isinstance(m, Histogram)
                         else m.value)
        return out

    def expose(self) -> str:
        """Plain-text exposition, one ``name value`` line per metric
        (histograms expand to ``name{count|sum|p50|p99}`` lines)."""
        lines = []
        for name, val in self.as_dict().items():
            if isinstance(val, dict):
                for k, v in val.items():
                    lines.append(f"{name}{{{k}}} {v}")
            else:
                lines.append(f"{name} {val}")
        return "\n".join(lines)


#: Every live registry, weakly held — what :func:`metrics_snapshot` walks.
#: Weak so short-lived test services don't accumulate forever.
_COMPONENTS: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()

#: The process-global registry: kernel dispatch counters, engine pass
#: latency, span accounting — everything not scoped to one component
#: instance.
_GLOBAL = MetricsRegistry("process")


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    return _GLOBAL


def metrics_snapshot() -> str:
    """Text exposition across every live registry in the process — the
    one dump a fleet agent scrapes.  Component registries (per-service
    stats and friends) are prefixed with their namespace; the global
    registry comes first, unprefixed."""
    chunks = [_GLOBAL.expose()]
    others = sorted((r for r in _COMPONENTS if r is not _GLOBAL),
                    key=lambda r: (r.namespace, id(r)))
    seen: dict[str, int] = {}
    for reg in others:
        if not reg.names():
            continue
        n = seen[reg.namespace] = seen.get(reg.namespace, 0) + 1
        prefix = f"{reg.namespace or 'component'}[{n - 1}]"
        body = reg.expose()
        chunks.append("\n".join(f"{prefix}/{line}"
                                for line in body.splitlines()))
    return "\n".join(c for c in chunks if c)


class StatsView:
    """Base for component stats: integer attributes backed by registry
    counters.

    Subclasses declare ``_FIELDS`` (the attribute names, in the order the
    historical ``as_dict()`` emitted them) and ``_NAMESPACE``.  Attribute
    reads return plain ints and ``stats.x += 1`` / ``stats.x = v`` write
    through to the counter, so every existing call site and test works
    unchanged — but the numbers live in a :class:`MetricsRegistry` the
    observability layer can export."""

    _FIELDS: tuple[str, ...] = ()
    _NAMESPACE = "stats"

    def __init__(self, metrics: MetricsRegistry | None = None):
        if metrics is None:
            metrics = MetricsRegistry(self._NAMESPACE)
        object.__setattr__(self, "metrics", metrics)
        for f in self._FIELDS:
            metrics.counter(f"{self._NAMESPACE}/{f}")

    def _counter(self, field: str) -> Counter:
        return self.metrics.counter(f"{self._NAMESPACE}/{field}")

    def __getattr__(self, name: str):
        if name in type(self)._FIELDS:
            return self._counter(name).value
        raise AttributeError(f"{type(self).__name__} has no attribute "
                             f"{name!r}")

    def __setattr__(self, name: str, value) -> None:
        if name in type(self)._FIELDS:
            self._counter(name).set(value)
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> dict:
        """The historical telemetry dict — identical key set and order,
        now a view over the metrics registry."""
        return {f: self._counter(f).value for f in self._FIELDS}

    def __eq__(self, other) -> bool:
        if isinstance(other, StatsView):
            return (type(self) is type(other)
                    and self.as_dict() == other.as_dict())
        return NotImplemented

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({body})"
