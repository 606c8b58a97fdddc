"""repro_torch.service — the online synthesis service layer.

Turns the offline multi-spec compiler into a serving system: typed
single-spec requests (:mod:`repro_torch.service.requests`) are canonicalized
(:mod:`repro_torch.service.keys`), answered from a content-addressed frontier
cache (:mod:`repro_torch.service.cache`), and cache misses are coalesced into one
fused pass through the shared execution engine
(:mod:`repro_torch.service.service`).  The async front
(:mod:`repro_torch.service.frontend`) builds those batches from an online request
stream: bounded admission queue, priority classes, an adaptive batching
window, explicit load shedding, and streamed frontier-so-far partials.
The shared artifact registry (:mod:`repro_torch.service.registry`) is the
fleet-wide third cache tier: CAS-safe concurrent writers on shared storage,
claim files so one host synthesizes a missing key, and scope-digest records
for fleet-wide invalidation scoped to exactly the recalibrated axis values.
Responses are bit-identical to fresh unbatched engine runs in every tier.
"""

from .artifacts import (ARTIFACT_SCHEMA, CacheArtifactError,
                        atomic_write_json, load_artifact, quarantine_artifact,
                        result_from_payload, result_to_payload)
from .cache import CacheStats, FrontierCache
from .frontend import (WINDOW_BOUNDS, WINDOW_FRACTION, FrontendStats,
                       ServiceFrontend, SweepHandle, Ticket)
from .keys import (axis_signatures, cache_key, canonical_spec, key_scope,
                   lattice_signature, slice_key, spec_key, stale_digests,
                   sweep_key)
from .registry import (CLAIM_TTL_S, ArtifactRegistry, RegistryClaim,
                       RegistryStats)
from .requests import (FRONTIER_EVENT, REQUEST_KINDS, SHED_REASONS, Priority,
                       RequestState, SheddedResponse, StreamEvent,
                       SynthesisRequest, SynthesisResponse, as_requests)
from .service import (SERVICE_MODES, ServiceStats, SynthesisService,
                      get_service, reset_service, resolve_service_mode)

__all__ = [
    "ARTIFACT_SCHEMA", "ArtifactRegistry", "CLAIM_TTL_S",
    "CacheArtifactError", "CacheStats", "FRONTIER_EVENT", "FrontendStats",
    "FrontierCache", "Priority", "RegistryClaim", "RegistryStats",
    "RequestState", "SERVICE_MODES", "SHED_REASONS", "ServiceFrontend",
    "ServiceStats", "SheddedResponse", "StreamEvent", "SweepHandle",
    "SynthesisRequest", "REQUEST_KINDS", "SynthesisResponse",
    "SynthesisService", "Ticket", "WINDOW_BOUNDS", "WINDOW_FRACTION",
    "as_requests", "atomic_write_json", "axis_signatures", "cache_key",
    "canonical_spec", "get_service", "key_scope", "lattice_signature",
    "load_artifact", "quarantine_artifact", "reset_service",
    "result_from_payload", "result_to_payload", "resolve_service_mode",
    "slice_key", "spec_key", "stale_digests", "sweep_key",
]
