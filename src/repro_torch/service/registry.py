"""Shared artifact registry: the cross-process / cross-host cache tier.

The :class:`repro_torch.service.cache.FrontierCache` makes one *process* warm; this
module makes a *fleet* warm.  :class:`ArtifactRegistry` is a
content-addressed store on shared storage (NFS mount, shared volume, one
host's exported directory) that any number of serving hosts read and write
concurrently, layered under the per-process cache as its third tier:

    memory LRU  →  local disk store  →  shared registry

Concurrent writers are safe **by construction**, not by locking:

  * content addressing — two hosts that synthesize the same
    :func:`repro_torch.service.keys.cache_key` produce bit-identical payloads
    (pinned by the differential suites), so whichever write lands last
    changes nothing;
  * unique-temp-then-atomic-rename (:func:`repro_torch.service.artifacts.
    atomic_write_json`) — readers see complete artifacts or nothing, never a
    partial write, even while N writers race on one key.

On top of that safety floor, *claim files* make the fleet cheap: before
synthesizing a registry miss, a host tries to :meth:`~ArtifactRegistry.claim`
the key — an ``O_CREAT | O_EXCL`` create of ``claims/<key>.claim``, which
exactly one host wins.  The winner synthesizes and publishes; the others
:meth:`~ArtifactRegistry.wait` for the artifact to appear (or time out and
synthesize anyway — a claim is an optimization, never a correctness gate, so
a crashed claim holder can only cost duplicated work; stale claims past
``claim_ttl_s`` are broken outright).

Every artifact carries a sidecar scope record (``objects/<key>.meta.json``):
the named content digests the entry depends on — per-axis signatures, the
per-value digest of its own slice, the ``__global__`` tech digest, the full
``lattice_signature`` (see :func:`repro_torch.service.keys.key_scope`).  A tech
recalibration then evicts *exactly* the stale entries fleet-wide:
:func:`repro_torch.service.keys.stale_digests` names the digests the change
retired, and :meth:`~ArtifactRegistry.invalidate_digests` drops every entry
that references one, leaving every other key warm (slice records of
untouched axis values survive a scoped recalibration — the per-axis
slice semantics of :mod:`repro_torch.service.keys`, now fleet-wide).

Layout under ``root``::

    objects/<key>.json        the frontier artifact (shared codec)
    objects/<key>.meta.json   scope digests for scoped invalidation
    claims/<key>.claim        CAS claim file (owner host/pid/time)
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..core.searcher import SearchResult
from ..obs.metrics import StatsView
from .artifacts import (CacheArtifactError, artifact_payload,
                        atomic_write_json, load_artifact,
                        quarantine_artifact)

#: Schema tag of one artifact's sidecar scope record.
META_SCHEMA = "syndcim-registry-meta/v1"

#: Schema tag of one claim file's owner record.
CLAIM_SCHEMA = "syndcim-registry-claim/v1"

#: Default age past which a claim is considered abandoned (the holder
#: crashed or was partitioned) and may be broken by another host.  Generous:
#: a full exhaustive sweep finishes well inside this on one host.
CLAIM_TTL_S = 600.0


class RegistryStats(StatsView):
    """Fleet-facing telemetry of one registry handle (per process),
    backed by a metrics registry (:class:`repro_torch.obs.metrics.StatsView` —
    same attributes and ``as_dict()`` key set as the historical
    dataclass).

    - ``hits``: artifacts fetched (validated) from the store
    - ``misses``: ``fetch()`` found no artifact
    - ``fills``: artifacts this process published
    - ``fill_noops``: publishes skipped, artifact already present
    - ``corrupt``: artifacts rejected (and quarantined)
    - ``claims_acquired`` / ``claims_lost`` / ``claims_broken`` /
      ``claims_released``: the claim-file protocol from this process's
      point of view
    - ``evictions``: entries dropped by scoped invalidation
    """

    _NAMESPACE = "registry"
    _FIELDS = ("hits", "misses", "fills", "fill_noops", "corrupt",
               "claims_acquired", "claims_lost", "claims_broken",
               "claims_released", "evictions")


class RegistryClaim:
    """One held claim on a registry key.  Release it once the artifact is
    published (or the attempt is abandoned); also a context manager."""

    def __init__(self, registry: "ArtifactRegistry", key: str, path: Path):
        self._registry = registry
        self.key = key
        self.path = path
        self.released = False

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        self._registry.stats.claims_released += 1
        try:
            os.unlink(self.path)
        except OSError:
            pass            # broken by another host after our TTL expired

    def __enter__(self) -> "RegistryClaim":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass
class ArtifactRegistry:
    """A shared frontier-artifact store under one root directory.

    Every method is safe to call concurrently from any number of processes
    and hosts sharing ``root``.  ``claim_ttl_s`` bounds how long a missing
    claim holder can block the fleet's claim optimization (never its
    correctness)."""

    root: str | os.PathLike
    claim_ttl_s: float = CLAIM_TTL_S
    stats: RegistryStats = field(default_factory=RegistryStats)

    def __post_init__(self):
        self.root = Path(self.root)
        self._objects = self.root / "objects"
        self._claims = self.root / "claims"
        self._objects.mkdir(parents=True, exist_ok=True)
        self._claims.mkdir(parents=True, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def object_path(self, key: str) -> Path:
        return self._objects / f"{key}.json"

    def meta_path(self, key: str) -> Path:
        return self._objects / f"{key}.meta.json"

    def claim_path(self, key: str) -> Path:
        return self._claims / f"{key}.claim"

    # -- the artifact protocol ----------------------------------------------

    def has(self, key: str) -> bool:
        """Cheap existence probe (no validation, no stats) — the poll the
        claim-wait loop spins on.  Serving always goes through
        :meth:`fetch`, which validates."""
        return self.object_path(key).exists()

    def fetch(self, key: str) -> SearchResult | None:
        """The validated artifact for ``key``, or None.  A corrupted or
        mis-keyed artifact is quarantined at rejection time (it can never be
        served, and the slot is clean for the next publish) and counts as a
        miss."""
        path = self.object_path(key)
        if not path.exists():
            self.stats.misses += 1
            return None
        try:
            stored_key, result = load_artifact(path)
            if stored_key != key:
                raise CacheArtifactError(
                    f"{path}: content key mismatch "
                    f"(stored {stored_key[:12]}…, wanted {key[:12]}…)")
        except CacheArtifactError:
            self.stats.corrupt += 1
            self.stats.misses += 1
            quarantine_artifact(path)
            return None
        self.stats.hits += 1
        return result

    def publish(self, key: str, result: SearchResult,
                scope: dict[str, str] | None = None) -> Path:
        """Write one artifact (and its scope record) into the shared store.

        Publishing an already-present key is a no-op for the object file
        (content addressing: the bytes would be identical; skipping saves
        shared-filesystem traffic when a claim loser synthesized anyway) —
        the scope record is still written if missing."""
        path = self.object_path(key)
        if path.exists():
            self.stats.fill_noops += 1
        else:
            atomic_write_json(path, artifact_payload(key, result))
            self.stats.fills += 1
        meta = self.meta_path(key)
        if scope is not None and not meta.exists():
            atomic_write_json(meta, {"schema": META_SCHEMA, "key": key,
                                     "scope": dict(scope)})
        return path

    # -- generic JSON payloads (non-frontier artifacts) -----------------------

    def publish_payload(self, key: str, payload: dict, *, schema: str,
                        scope: dict[str, str] | None = None) -> Path:
        """Publish an arbitrary JSON payload under ``key`` with an explicit
        ``schema`` tag — the registry's store/claim/invalidation machinery
        for artifacts that are not frontier :class:`SearchResult`\\ s (e.g.
        the kernel autotuner's tile winners).  Same no-op-if-present and
        scope-record semantics as :meth:`publish`."""
        path = self.object_path(key)
        if path.exists():
            self.stats.fill_noops += 1
        else:
            atomic_write_json(path, {"schema": schema, "key": key,
                                     "payload": payload})
            self.stats.fills += 1
        meta = self.meta_path(key)
        if scope is not None and not meta.exists():
            atomic_write_json(meta, {"schema": META_SCHEMA, "key": key,
                                     "scope": dict(scope)})
        return path

    def fetch_payload(self, key: str, *, schema: str) -> dict | None:
        """The validated payload stored under ``key``, or None.  An artifact
        with the wrong schema tag, a mismatched key, or unparseable bytes is
        quarantined (same policy as :meth:`fetch`) and counts as a miss."""
        path = self.object_path(key)
        if not path.exists():
            self.stats.misses += 1
            return None
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            data = None
        if (not isinstance(data, dict) or data.get("schema") != schema
                or data.get("key") != key
                or not isinstance(data.get("payload"), dict)):
            self.stats.corrupt += 1
            self.stats.misses += 1
            quarantine_artifact(path)
            return None
        self.stats.hits += 1
        return data["payload"]

    # -- the claim protocol --------------------------------------------------

    def claim(self, key: str) -> RegistryClaim | None:
        """Try to become the one host that synthesizes ``key``.

        Returns a held :class:`RegistryClaim` if this process won the
        ``O_CREAT | O_EXCL`` race (release it after publishing), or None if
        another holder owns a live claim.  A stale claim (older than
        ``claim_ttl_s``) is broken and the attempt retried once."""
        path = self.claim_path(key)
        for attempt in (0, 1):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if attempt == 0 and self._break_stale_claim(path):
                    continue
                self.stats.claims_lost += 1
                return None
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": CLAIM_SCHEMA, "key": key,
                           "host": socket.gethostname(),
                           "pid": os.getpid(), "time": time.time()}, f)
                f.flush()
                os.fsync(f.fileno())
            self.stats.claims_acquired += 1
            return RegistryClaim(self, key, path)
        return None

    def _break_stale_claim(self, path: Path) -> bool:
        """Remove a claim whose holder has been gone past the TTL.  Age is
        judged by the claim file's mtime (wall-clock inside the file is
        advisory only — hosts' clocks need not agree)."""
        try:
            age = time.time() - path.stat().st_mtime
        except OSError:
            return True          # holder released it between our two looks
        if age < self.claim_ttl_s:
            return False
        try:
            os.unlink(path)
        except OSError:
            pass                 # another waiter broke it first — still free
        self.stats.claims_broken += 1
        return True

    def wait(self, key: str, timeout_s: float,
             poll_s: float = 0.02) -> bool:
        """Wait for another host's claimed synthesis of ``key`` to publish.
        True as soon as the artifact exists; False on timeout (the caller
        then synthesizes itself — duplicated work, never a wrong answer)."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self.has(key):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(poll_s, max(0.0,
                                       deadline - time.monotonic())))

    # -- enumeration + scoped invalidation ------------------------------------

    def keys(self) -> list[str]:
        """Every key with a (non-quarantined) artifact in the store."""
        return sorted(p.name[:-len(".json")] for p in
                      self._objects.glob("*.json")
                      if not p.name.endswith(".meta.json"))

    def scope_of(self, key: str) -> dict[str, str] | None:
        """The stored scope-digest record of one entry (None if the entry
        was published without one — such entries only leave by
        :meth:`invalidate_key`)."""
        meta = self.meta_path(key)
        try:
            data = json.loads(meta.read_text())
        except (OSError, ValueError):
            return None
        if (not isinstance(data, dict)
                or data.get("schema") != META_SCHEMA):
            return None
        scope = data.get("scope")
        return dict(scope) if isinstance(scope, dict) else None

    def invalidate_key(self, key: str) -> bool:
        """Drop one entry (artifact + scope record) fleet-wide."""
        removed = False
        for path in (self.object_path(key), self.meta_path(key)):
            try:
                os.unlink(path)
                removed = True
            except OSError:
                pass
        if removed:
            self.stats.evictions += 1
        return removed

    def invalidate_digests(self, stale: set[str]) -> list[str]:
        """Scoped eviction: drop every entry whose scope record references
        any digest in ``stale`` (the set :func:`repro_torch.service.keys.
        stale_digests` computes for a recalibration).  Entries none of whose
        digests were retired stay warm — a scoped tech recalibration
        invalidates exactly the affected axis-value's entries, fleet-wide.
        Returns the evicted keys."""
        stale = set(stale)
        evicted = []
        for key in self.keys():
            scope = self.scope_of(key)
            if scope is not None and stale & set(scope.values()):
                if self.invalidate_key(key):
                    evicted.append(key)
        return evicted

    def telemetry(self) -> dict:
        """This handle's stats plus the store-wide entry count."""
        out = self.stats.as_dict()
        out["entries"] = len(self.keys())
        return out
