"""Content-addressed frontier cache: in-memory LRU + on-disk + shared tiers.

The cache maps :func:`repro_torch.service.keys.cache_key` content addresses to
synthesized :class:`repro_torch.core.searcher.SearchResult` frontiers.  Hits are
bit-identical to a fresh engine run by construction: the in-memory tier
returns the very object the engine produced, and the disk tiers round-trip
through the lossless JSON encoding of :mod:`repro_torch.service.artifacts`.

Lookups probe three tiers, cheapest first:

  1. **memory** — the per-process LRU (``capacity`` entries);
  2. **local disk** — one ``<key>.json`` artifact per frontier under
     ``store_dir``, what makes a *second process on the same host* warm
     (``launch.serve --dcim-cache PATH``);
  3. **shared registry** — an optional
     :class:`repro_torch.service.registry.ArtifactRegistry` on shared storage,
     what makes a *fleet* warm: any spec synthesized anywhere is a hit
     everywhere (``launch.serve --dcim-registry PATH``).

A hit in a lower tier is promoted into every tier above it (a registry hit
is re-persisted into the local store and inserted into the LRU), and a put
is written through every tier below the LRU.  A corrupted or foreign
artifact in either disk tier is rejected (:class:`CacheArtifactError`),
counted, **quarantined at rejection time** (renamed to ``<key>.corrupt`` so
it can never warm-start another process), and treated as a miss of that
tier — the lookup falls through to the next tier, so a shared registry can
heal a locally poisoned artifact; a bad byte on disk can never poison a
served frontier.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

from ..core.searcher import SearchResult
from ..obs import tracer
from ..obs.metrics import StatsView
from .artifacts import (ARTIFACT_SCHEMA, CacheArtifactError,  # noqa: F401
                        artifact_payload, atomic_write_json, load_artifact,
                        quarantine_artifact)
from .registry import ArtifactRegistry


class CacheStats(StatsView):
    """Per-tier accounting, backed by a metrics registry
    (:class:`repro_torch.obs.metrics.StatsView` — same attributes and
    ``as_dict()`` key set as the historical dataclass).

    Invariant (property-tested): ``gets == hits + disk_hits + shared_hits
    + misses`` — every ``get()`` resolves in exactly one tier or is a
    miss; ``corrupt`` counts rejected artifacts on the side (a rejection
    is not a resolution).  ``hits`` are in-memory LRU hits, ``disk_hits``
    artifacts loaded (and promoted) from local disk, ``shared_hits``
    artifacts fetched from the shared registry.  Evictions split by
    durability: ``evictions`` are LRU entries that survive in a disk
    tier, ``evictions_lost`` left no copy anywhere."""

    _NAMESPACE = "cache"
    _FIELDS = ("gets", "hits", "disk_hits", "shared_hits", "misses",
               "puts", "evictions", "evictions_lost", "corrupt")


@dataclass
class FrontierCache:
    """LRU of synthesized frontiers, content-addressed, optionally
    persistent and optionally fleet-shared.

    ``capacity`` bounds the in-memory tier only; with a ``store_dir`` every
    put is also written through to local disk, and with a ``registry`` it is
    additionally published to the shared store (misses fall back through
    both, promoting on the way up)."""

    capacity: int = 256
    store_dir: str | os.PathLike | None = None
    registry: ArtifactRegistry | None = None
    stats: CacheStats = field(default_factory=CacheStats)

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self._lru: OrderedDict[str, SearchResult] = OrderedDict()
        if self.store_dir is not None:
            self.store_dir = Path(self.store_dir)
            self.store_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self) -> int:
        return len(self._lru)

    # Deliberately no __contains__: the only truthful presence probe is
    # get(), which validates disk artifacts; a cheaper membership test would
    # report corrupted artifacts as present.

    # -- artifact layer ------------------------------------------------------

    def artifact_path(self, key: str) -> Path | None:
        return None if self.store_dir is None else self.store_dir / f"{key}.json"

    @staticmethod
    def load_artifact(path) -> tuple[str, SearchResult]:
        """Read and validate one artifact; returns ``(key, result)``.
        Raises :class:`CacheArtifactError` on any defect."""
        return load_artifact(path)

    def save_artifact(self, key: str, result: SearchResult) -> Path:
        """Write one local artifact via the unique-temp-then-atomic-rename
        discipline (:func:`repro_torch.service.artifacts.atomic_write_json`):
        concurrent writers of the same key — even across hosts when
        ``store_dir`` is on shared storage — never clobber each other's
        partial writes, and readers only ever see complete artifacts."""
        return atomic_write_json(self.artifact_path(key),
                                 artifact_payload(key, result))

    def _load_local(self, key: str) -> SearchResult | None:
        """Tier 2: the validated local artifact, quarantining rejects."""
        path = self.artifact_path(key)
        if path is None or not path.exists():
            return None
        try:
            stored_key, result = load_artifact(path)
            if stored_key != key:
                raise CacheArtifactError(
                    f"{path}: content key mismatch "
                    f"(stored {stored_key[:12]}…, wanted {key[:12]}…)")
        except CacheArtifactError:
            self.stats.corrupt += 1
            quarantine_artifact(path)
            return None
        return result

    # -- cache protocol ------------------------------------------------------

    def get(self, key: str) -> SearchResult | None:
        """The cached frontier for ``key``, or None.  Probes memory, then
        local disk, then the shared registry; disk-tier artifacts are
        validated and a rejected artifact is quarantined on the spot, the
        lookup falling through to the next tier."""
        self.stats.gets += 1
        with tracer.span("cache.mem") as span:
            if key in self._lru:
                self._lru.move_to_end(key)
                self.stats.hits += 1
                span.set_tag("outcome", "hit")
                return self._lru[key]
            span.set_tag("outcome", "miss")
        if self.store_dir is not None:
            with tracer.span("cache.disk") as span:
                result = self._load_local(key)
                if result is not None:
                    self.stats.disk_hits += 1
                    self._insert(key, result)
                    span.set_tag("outcome", "hit")
                    return result
                span.set_tag("outcome", "miss")
        if self.registry is not None:
            with tracer.span("cache.registry") as span:
                result = self.registry.fetch(key)
                if result is not None:
                    self.stats.shared_hits += 1
                    if self.store_dir is not None:
                        self.save_artifact(key, result)  # promote to tier 2
                    self._insert(key, result)
                    span.set_tag("outcome", "hit")
                    return result
                span.set_tag("outcome", "miss")
        self.stats.misses += 1
        return None

    def put(self, key: str, result: SearchResult,
            scope: dict[str, str] | None = None) -> None:
        """Insert into every tier.  ``scope`` is the invalidation-scope
        digest map published alongside the shared-registry copy
        (:func:`repro_torch.service.keys.key_scope`); ignored without a
        registry."""
        self.stats.puts += 1
        self._insert(key, result)
        if self.store_dir is not None:
            self.save_artifact(key, result)
        if self.registry is not None:
            self.registry.publish(key, result, scope=scope)

    def _insert(self, key: str, result: SearchResult) -> None:
        self._lru[key] = result
        self._lru.move_to_end(key)
        while len(self._lru) > self.capacity:
            evicted, _ = self._lru.popitem(last=False)
            path = self.artifact_path(evicted)
            durable = ((path is not None and path.exists())
                       or (self.registry is not None
                           and self.registry.has(evicted)))
            if durable:
                self.stats.evictions += 1
            else:
                self.stats.evictions_lost += 1
