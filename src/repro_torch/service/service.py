"""Online synthesis service: request coalescing over the execution engine.

`SynthesisService` is the serving front of the compiler: callers submit
typed :class:`~repro_torch.service.requests.SynthesisRequest`\\ s and the service
answers them from three tiers, cheapest first —

  1. **cache** — the content-addressed :class:`repro_torch.service.cache.
     FrontierCache` (in-memory LRU, optionally disk-persistent), hit when any
     earlier request synthesized the same ``(spec, tech, lattice, resolution,
     eps)`` address;
  2. **coalescing** — duplicate requests inside one batch collapse onto a
     single miss (they fan back out after the pass, every duplicate served
     the same result object);
  3. **one fused engine pass** — all remaining unique misses go through
     ``engine.plan_for`` (which micro-batches them into vmap groups by
     ``engine.group_key``) and ONE ``engine.execute`` call per execution
     mode on the service's device (vmap; the sharded modes wait for the
     port's sharded engine, see :data:`SERVICE_MODES`).

So N singleton requests cost one fused pass, not N — and a repeated request
costs zero engine executions (observable through
:func:`repro_torch.core.engine.add_execute_hook`).  Results are bit-identical to
fresh unbatched engine runs in every tier: the engine's strategies are
bit-identical to each other by the differential oracle harness, in-memory
hits return the engine's own objects, and disk hits round-trip through the
lossless artifact encoding.

    from repro_torch.service import SynthesisRequest, SynthesisService
    svc = SynthesisService()                  # on the CUDA card
    responses = svc.serve([SynthesisRequest(spec=s) for s in specs])
    again = svc.serve([SynthesisRequest(spec=specs[0])])   # zero executions

The older kwarg-tuple entry points — ``synthesize(spec, tech=,
resolution=)``, ``synthesize_many(...)``, ``request_key(...)`` — remain as
thin deprecation shims that construct requests internally and return bare
``SearchResult``\\ s, bit-identical to the typed path.  The *async* front
(admission queue, priority classes, backpressure, streaming) lives one
layer up in :mod:`repro_torch.service.frontend`; this module stays synchronous
and thread-compatible (callers serialize on the frontend's scheduler).
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import batched as B
from ..core import engine as E
from ..core import subcircuits as sc
from ..core.axes import SLICEABLE_AXES, LatticeConfig, seed_config
from ..core.macro import MacroSpec, calibrated_tech_for_reference
from ..core.pareto import merged_pareto_indices, nondominated_mask_auto
from ..core.searcher import SearchResult
from ..core.tech import TechModel
from ..device import resolve_device
from ..obs import install_engine_hooks, tracer
from ..obs.metrics import StatsView
from .cache import FrontierCache
from .keys import cache_key, key_scope, slice_key, sweep_key
from .requests import SynthesisRequest, SynthesisResponse, as_requests

#: Reusable no-op context for the untraced fast path (a shared
#: ``nullcontext`` instance is re-enterable and allocation-free).
_NULL_CTX = contextlib.nullcontext()

#: Request-side execution modes: "auto" picks vmap for small fused batches
#: and the sharded pick once a batch is big enough to pay for device
#: placement; "sharded" forces the sharded pick; the public sharded names
#: select one strategy.  The port's engine has no sharded strategy yet, so
#: every sharded pick raises :class:`NotImplementedError` naming where it is
#: queued (:func:`repro_torch.core.engine._sharded_not_ported`), never a
#: silent vmap in its place.
SERVICE_MODES = ("auto", "vmap", "sharded", "jit", "pmap", "multihost")

#: "auto" shards a fused miss batch only when it stacks at least this many
#: spec lanes per visible device — below that, padding the batch up to the
#: device count plus placement overhead beats the dispatch it saves (the
#: same payoff-point reasoning as ``pareto.SHARDED_EXTRACT_MIN_POINTS``).
SHARD_MIN_SPECS_PER_DEVICE = 2


def resolve_service_mode(mode: str = "auto", n_specs: int | None = None,
                         device=None) -> str:
    """Public service mode -> engine strategy name.  ``n_specs`` (the fused
    batch size) lets "auto" apply the sharding payoff threshold against the
    number of devices of ``device``'s kind (the CUDA cards visible, or 1
    for the CPU; ``None``: the card); without it "auto" stays on the
    single-device vmap strategy.  A sharded pick raises
    :class:`NotImplementedError`: the port's sharded engine is not there
    yet."""
    if mode not in SERVICE_MODES:
        raise ValueError(f"unknown service mode: {mode!r}; "
                         f"pick from {SERVICE_MODES}")
    if mode == "auto":
        big = False
        if n_specs is not None:
            n_dev = (torch.cuda.device_count()
                     if resolve_device(device).type == "cuda" else 1)
            big = n_dev > 1 and n_specs >= SHARD_MIN_SPECS_PER_DEVICE * n_dev
        mode = "sharded" if big else "vmap"
    if mode == "vmap":
        return "vmap"
    raise E._sharded_not_ported(f"service mode {mode!r}")


class ServiceStats(StatsView):
    """Per-service request counters, backed by a metrics registry
    (:class:`repro_torch.obs.metrics.StatsView` — same attributes and
    ``as_dict()`` key set as the historical dataclass).

    - ``cache_hits``: answered from the FrontierCache (any tier)
    - ``coalesced``: duplicates folded onto an in-batch miss
    - ``misses``: unique specs that reached the engine
    - ``fused_passes``: engine.execute calls this service made
    - ``slice_hits``: per-axis slice frontiers reused by sweeps
    - ``incremental_passes``: sweeps answered by slice merge, not re-roll
    - claim counters (the shared-registry protocol; zero without a
      registry): ``claims_acquired`` misses this service claimed and
      synthesized, ``claim_waits`` misses another host was already
      synthesizing, ``claim_hits`` of those served by that host's publish,
      ``claim_timeouts`` of those synthesized here after the wait.
    """

    _NAMESPACE = "service"
    _FIELDS = ("requests", "cache_hits", "coalesced", "misses",
               "fused_passes", "slice_hits", "incremental_passes",
               "claims_acquired", "claim_waits", "claim_hits",
               "claim_timeouts")


def _deprecated(old: str) -> None:
    warnings.warn(
        f"SynthesisService.{old} with kwarg tuples is deprecated; build "
        "SynthesisRequest objects and call serve() (see README migration "
        "table)", DeprecationWarning, stacklevel=3)


@dataclass
class SynthesisService:
    """The online synthesis front over the shared execution engine.

    ``tech``/``resolution``/``memcells`` are per-service defaults; each can
    be overridden per request, and the cache address always reflects the
    values a request actually ran under, so one service instance safely
    serves mixed tech models and resolutions — even inside one fused pass
    (operands are packed per spec lane with that request's own tech).
    ``mode`` picks the execution strategy for fused miss passes (see
    :data:`SERVICE_MODES`); a request's ``mode`` overrides it per request.

    With a registry-backed cache the service speaks the fleet claim
    protocol: before synthesizing a registry miss it tries to claim the key
    (:meth:`repro_torch.service.registry.ArtifactRegistry.claim`); on a lost claim
    it waits up to ``claim_wait_s`` seconds for the claiming host's publish
    (served as a cache hit) before synthesizing anyway — a claim is an
    optimization, never a correctness gate.

    ``device`` is where every fused pass runs: ``None`` means the CUDA card
    and raises where there is none (pass ``device="cpu"`` to serve on the
    CPU).  It is resolved once, when the service is built, so a scheduler
    thread never reads the per-thread current CUDA device.
    """

    tech: TechModel | None = None
    resolution: int = 4
    memcells: tuple[sc.MemCellKind, ...] = (sc.MemCellKind.SRAM_6T,)
    mode: str = "auto"
    config: LatticeConfig | None = None
    cache: FrontierCache = field(default_factory=FrontierCache)
    stats: ServiceStats = field(default_factory=ServiceStats)
    claim_wait_s: float = 30.0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tech is None:
            self.tech = calibrated_tech_for_reference()
        resolve_service_mode(self.mode)      # validate eagerly
        self.memcells = tuple(self.memcells)
        install_engine_hooks()               # idempotent observation hooks

    # -- effective per-request parameters -----------------------------------

    def _effective(self, req: SynthesisRequest
                   ) -> tuple[TechModel, int, str, LatticeConfig]:
        tech = req.tech if req.tech is not None else self.tech
        resolution = (self.resolution if req.resolution is None
                      else int(req.resolution))
        mode = req.mode if req.mode is not None else self.mode
        if req.config is not None:
            config = req.config
        elif self.config is not None:
            config = self.config
        else:
            config = seed_config(self.memcells)
        return tech, resolution, mode, config

    # -- keys ----------------------------------------------------------------

    def key_for(self, request: SynthesisRequest) -> str:
        """The content address a typed request is cached under: the search
        address for ``kind="search"``, the exhaustive-sweep address for
        ``kind="sweep"`` (see :mod:`repro_torch.service.keys`)."""
        tech, resolution, _, config = self._effective(request)
        if request.kind == "sweep":
            return sweep_key(request.spec, tech, config)
        return cache_key(request.spec, tech, resolution=resolution,
                         config=config)

    def request_key(self, spec: MacroSpec, tech: TechModel | None = None,
                    resolution: int | None = None) -> str:
        """Deprecated kwarg-tuple shim for :meth:`key_for`."""
        _deprecated("request_key(spec, tech=, resolution=)")
        return self.key_for(SynthesisRequest(spec=spec, tech=tech,
                                             resolution=resolution))

    # -- the typed service protocol ------------------------------------------

    def serve(self, requests: Sequence[SynthesisRequest],
              on_partial: Optional[Callable[[int, SearchResult], None]]
              = None, contexts: Sequence | None = None
              ) -> list[SynthesisResponse]:
        """Serve a batch of typed requests: dedup against the cache and each
        other, one fused engine pass per execution mode for the misses, fan
        results back out in request order.  Per-request results are
        bit-identical to a fresh ``mso_search_many([spec])`` run.

        ``on_partial(index, result)`` streams each request's finished
        ``SearchResult`` the moment it exists — cache hits immediately,
        fused-pass lanes as each spec's Algorithm-1 replay completes — so a
        long sweep's frontier-so-far is observable before the batch returns.

        ``contexts`` (parallel to ``requests``) carries each request's
        :class:`repro_torch.obs.SpanContext` across the thread boundary — the
        frontend passes its tickets' trace roots so per-tier cache spans and
        the engine-pass link attach to the right trace.  ``None`` entries
        (or no list at all) simply record no request-scoped spans.
        """
        reqs = list(requests)
        for r in reqs:
            if not isinstance(r, SynthesisRequest):
                raise TypeError("serve() takes SynthesisRequest objects; "
                                "use the synthesize_many shim for bare "
                                f"specs (got {type(r).__name__})")
        if contexts is not None and len(contexts) != len(reqs):
            raise ValueError(f"contexts must parallel requests: "
                             f"{len(contexts)} != {len(reqs)}")
        ctxs = list(contexts) if contexts is not None else [None] * len(reqs)
        eff = [self._effective(r) for r in reqs]
        keys = [self.key_for(r) for r in reqs]
        out: list[SynthesisResponse | None] = [None] * len(reqs)

        first_for_key: dict[str, int] = {}
        dups_of: dict[int, list[int]] = {}
        miss_by_mode: dict[str, list[int]] = {}
        sweep_misses: list[int] = []
        claims: dict[str, object] = {}       # key -> held RegistryClaim
        for i, (r, k) in enumerate(zip(reqs, keys)):
            self.stats.requests += 1
            with (tracer.activate(ctxs[i]) if ctxs[i] is not None
                  else _NULL_CTX):
                hit = self.cache.get(k)
                if hit is None and first_for_key.get(k) is None:
                    hit, claim = self._claim_or_wait(k)
                    if claim is not None:
                        claims[k] = claim
            if hit is not None:
                self.stats.cache_hits += 1
                out[i] = SynthesisResponse(request=r, result=hit,
                                           served_from="cache")
                if on_partial is not None:
                    on_partial(i, hit)
                continue
            j = first_for_key.get(k)
            if j is not None:
                self.stats.coalesced += 1
                dups_of.setdefault(j, []).append(i)
                continue                     # fans out from the fused pass
            first_for_key[k] = i
            if r.kind == "sweep":
                sweep_misses.append(i)
            else:
                miss_by_mode.setdefault(eff[i][2], []).append(i)

        def link_engine_span(i: int, pass_ref: dict | None,
                             coalesced: bool) -> None:
            """A per-request child span covering the shared fused pass —
            tagged with the pass's own trace/span ids so N coalesced
            requests all point at the ONE ``engine.pass`` timeline."""
            if not pass_ref or ctxs[i] is None:
                return
            span = tracer.start("request.engine", parent=ctxs[i],
                                start_s=pass_ref["start_s"],
                                tags={"engine_pass": pass_ref["span_id"],
                                      "engine_trace": pass_ref["trace_id"],
                                      "coalesced": coalesced})
            if span:
                span.finish()

        def finish(i: int, res: SearchResult,
                   pass_ref: dict | None = None) -> None:
            tech_i, _res_i, _mode_i, config_i = eff[i]
            self.cache.put(keys[i], res,
                           scope=key_scope(tech_i, config_i))
            claim = claims.pop(keys[i], None)
            if claim is not None:
                claim.release()
            out[i] = SynthesisResponse(request=reqs[i], result=res,
                                       served_from="engine")
            link_engine_span(i, pass_ref, coalesced=False)
            if on_partial is not None:
                on_partial(i, res)
            for d in dups_of.get(i, ()):
                out[d] = SynthesisResponse(request=reqs[d], result=res,
                                           served_from="coalesced")
                link_engine_span(d, pass_ref, coalesced=True)
                if on_partial is not None:
                    on_partial(d, res)

        for mode, members in miss_by_mode.items():
            self.stats.misses += len(members)
            pass_ref: dict = {}
            self._fused_pass([reqs[i] for i in members],
                             [eff[i] for i in members], mode,
                             lambda slot, res, _m=members, _p=pass_ref:
                                 finish(_m[slot], res, _p),
                             pass_ref=pass_ref)

        for i in sweep_misses:
            self.stats.misses += 1
            tech, _res, _mode, config = eff[i]
            with (tracer.activate(ctxs[i]) if ctxs[i] is not None
                  else _NULL_CTX):
                with tracer.span("service.sweep",
                                 tags={"kind": "sweep"}):
                    res = self._serve_sweep(reqs[i].spec, tech, config)
            finish(i, res)
        return out

    # -- the fleet claim protocol --------------------------------------------

    def _claim_or_wait(self, key: str):
        """One registry miss through the claim protocol.  Returns ``(hit,
        claim)``: a served result if another host's claimed synthesis
        published while we waited, else a held claim if this service won the
        key (released by ``finish`` after the put), else ``(None, None)`` —
        wait timed out or no registry, synthesize unsynchronized (safe:
        content addressing + atomic rename make duplicate writers
        harmless)."""
        registry = self.cache.registry
        if registry is None:
            return None, None
        with tracer.span("cache.claim") as span:
            claim = registry.claim(key)
            if claim is not None:
                self.stats.claims_acquired += 1
                span.set_tag("outcome", "acquired")
                return None, claim
            self.stats.claim_waits += 1
            if registry.wait(key, timeout_s=self.claim_wait_s):
                hit = self.cache.get(key)    # validated fetch + promotion
                if hit is not None:
                    self.stats.claim_hits += 1
                    span.set_tag("outcome", "claim-wait-hit")
                    return hit, None
            self.stats.claim_timeouts += 1
            span.set_tag("outcome", "claim-wait-timeout")
            return None, None

    def telemetry(self) -> dict:
        """Fleet-facing stats rollup: this service's request counters, its
        cache's per-tier counters, and — when fleet-shared — the registry
        handle's hit/miss/fill/claim counters plus store size.  What
        ``launch.serve`` and ``scripts/warm_cache.py`` print."""
        out = {"service": self.stats.as_dict(),
               "cache": self.cache.stats.as_dict()}
        if self.cache.registry is not None:
            out["registry"] = self.cache.registry.telemetry()
        return out

    # -- deprecated kwarg-tuple shims ----------------------------------------

    def synthesize(self, spec: MacroSpec, tech: TechModel | None = None,
                   resolution: int | None = None) -> SearchResult:
        """Deprecated shim: one single-spec request (the N=1 batch)."""
        _deprecated("synthesize(spec, tech=, resolution=)")
        return self.serve(as_requests([spec], tech=tech,
                                      resolution=resolution))[0].result

    def synthesize_many(self, specs: Sequence[MacroSpec],
                        tech: TechModel | None = None,
                        resolution: int | None = None) -> list[SearchResult]:
        """Deprecated shim: bare specs in, bare ``SearchResult``\\ s out —
        constructs typed requests internally; bit-identical to
        :meth:`serve`."""
        _deprecated("synthesize_many(specs, tech=, resolution=)")
        return [r.result for r in
                self.serve(as_requests(specs, tech=tech,
                                       resolution=resolution))]

    # -- the fused miss pass -------------------------------------------------

    def _fused_pass(self, requests: Sequence[SynthesisRequest],
                    eff: Sequence[tuple[TechModel, int, str, LatticeConfig]],
                    mode: str,
                    on_result: Callable[[int, SearchResult], None],
                    pass_ref: dict | None = None) -> None:
        """All same-mode misses through one ``engine.execute`` call:
        ``engine.plan_for`` micro-batches them into vmap groups by
        ``engine.group_key`` (operands packed with each request's own tech,
        so mixed-tech batches still fuse), the placed strategy runs each
        group fused, and Algorithm 1 is replayed per spec at that request's
        resolution (exactly the ``mso_search_many`` contract, under
        whichever strategy the service resolved).  ``on_result(slot,
        result)`` fires as each spec lane finishes — the streaming hook.

        When tracing is on, the pass runs under an ``engine.pass`` trace of
        its own (a fused pass is shared by N requests, so it cannot live
        inside any single request's trace) with ``engine.plan`` /
        ``engine.place`` / ``engine.execute`` / per-lane ``engine.extract``
        phase children; ``pass_ref`` (when given) is filled with the pass
        span's ids so the caller can cross-link each request's trace to it.
        """
        with tracer.start_trace("engine.pass",
                                tags={"mode": mode,
                                      "n_requests": len(requests)}) as root:
            if pass_ref is not None and root:
                pass_ref.update(trace_id=root.trace_id,
                                span_id=root.span_id,
                                start_s=root.span.start_s)
            with tracer.span("engine.plan"):
                lattices = [B.DesignLattice.enumerate(r.spec, config=cfg)
                            for r, (_, _, _, cfg) in zip(requests, eff)]
                tables = [B.SpecTables(r.spec, tech, config=cfg)
                          for r, (tech, _, _, cfg) in zip(requests, eff)]
            with tracer.span("engine.place") as pspan:
                placement = E.place(
                    resolve_service_mode(mode, len(requests), self.device),
                    device=self.device)
                pspan.set_tag("mode", placement.mode)
                pspan.set_tag("n_dev", placement.n_dev)
            plan = E.plan_for(lattices, tables, placement=placement)
            evals = E.execute(plan)          # engine.execute span: obs hooks
            self.stats.fused_passes += 1
            for slot, (lat, tab, T) in enumerate(evals):
                with tracer.span("engine.extract", tags={"slot": slot}):
                    res = B._alg1_replay(lat, tab, T, eff[slot][1])
                on_result(slot, res)

    # -- exhaustive sweeps: slice caching + incremental re-synthesis ---------

    def _serve_sweep(self, spec: MacroSpec, tech: TechModel,
                     config: LatticeConfig) -> SearchResult:
        """One exhaustive-sweep miss.

        Probes the per-axis-value *slice* caches first: if some sliceable
        axis has cached frontiers for a subset of its values (the shape left
        behind by a scoped tech recalibration or a single-axis growth — see
        :mod:`repro_torch.service.keys`), only the sublattice of the missing
        values is evaluated and its slice frontiers are merged with the
        cached ones (:func:`repro_torch.core.pareto.merged_pareto_indices`), never
        re-rolling the full axis product.  A fully cold sweep evaluates the
        whole lattice once and leaves slice records behind for every
        sliceable axis, so the *next* single-axis change is incremental."""
        lattice = B.DesignLattice.enumerate(spec, config=config)
        best: tuple[str, dict[int, SearchResult], list[str]] | None = None
        for axis in SLICEABLE_AXES:
            ax = lattice.axis(axis)
            if ax is None:
                continue
            skeys = [slice_key(spec, tech, axis, v, config=config)
                     for v in range(ax.size)]
            cached = {}
            for v, sk in enumerate(skeys):
                rec = self.cache.get(sk)
                if rec is not None:
                    cached[v] = rec
            if cached and (best is None or len(cached) > len(best[1])):
                best = (axis, cached, skeys)

        if best is None:
            return self._cold_sweep(spec, tech, config, lattice)

        axis, cached, skeys = best
        self.stats.incremental_passes += 1
        self.stats.slice_hits += len(cached)
        missing = [v for v in range(lattice.axis(axis).size)
                   if v not in cached]
        fresh: dict[int, SearchResult] = {}
        if missing:
            sub, _parent = lattice.sublattice(axis, tuple(missing))
            subtab = B.SpecTables(spec, tech, axes=sub.axes)
            sweep = B.BatchedSweep(lattice=sub, tables=subtab,
                                   ppa=B.evaluate(sub, subtab,
                                                  device=self.device),
                                   device=self.device)
            local = sub.coord(axis)
            for li, v in enumerate(missing):
                rec = _slice_record(sweep, local == li)
                fresh[v] = rec
                self.cache.put(skeys[v], rec,
                               scope=key_scope(tech, config, axis=axis,
                                               value_index=v))
        records = [cached[v] if v in cached else fresh[v]
                   for v in range(lattice.axis(axis).size)]
        return _merge_slice_results(lattice, records)

    def _cold_sweep(self, spec: MacroSpec, tech: TechModel,
                    config: LatticeConfig,
                    lattice: B.DesignLattice) -> SearchResult:
        sweep = B.design_space_sweep(spec, tech, config=config,
                                     device=self.device)
        for axis in SLICEABLE_AXES:
            ax = sweep.lattice.axis(axis)
            if ax is None:
                continue
            coord = sweep.lattice.coord(axis)
            for v in range(ax.size):
                self.cache.put(slice_key(spec, tech, axis, v, config=config),
                               _slice_record(sweep, coord == v),
                               scope=key_scope(tech, config, axis=axis,
                                               value_index=v))
        return _sweep_result(sweep)


# -- sweep-result helpers (shared by the cold and incremental paths) --------


def _sweep_objectives(points) -> list[tuple[float, float, float]]:
    """The searcher's objective tuple (energy/cycle INT-lo, area, period)
    recomputed from materialized points — the same float64 values the
    batched sweep's objective matrix holds, so merged extraction compares
    exactly what a full-lattice extraction would."""
    return [(p.e_cycle_fj["int_lo"], p.area_um2, 1.0 / p.fmax_hz)
            for p in points]


def _extract_sweep_indices(sweep: B.BatchedSweep,
                           cand: np.ndarray) -> list[int]:
    """Frontier flat indices over an explicit candidate set (no feasibility
    fallback — the slice records need the raw feasible/valid split)."""
    if cand.size == 0:
        return []
    objs = sweep.objectives()[cand]
    return [int(cand[j])
            for j in E.extract_frontier(objs, nondominated_mask_auto)]


def _slice_record(sweep: B.BatchedSweep, sel: np.ndarray) -> SearchResult:
    """The cacheable frontier record of one axis-value slice of a sweep.

    Encoded as a :class:`SearchResult` so it rides the existing artifact
    codec: ``frontier`` is the slice's *feasible* frontier (empty when no
    point meets timing — deliberately no fallback, so "any feasible point in
    the full lattice" is recoverable as "any slice frontier non-empty"),
    ``explored`` is the slice's frontier over all valid points regardless of
    feasibility (the fallback pool), and ``n_evaluated`` is the slice's
    valid-point count (slices partition the lattice along one axis, so these
    sum to the full count)."""
    valid = sweep.lattice.valid & sel
    feas = valid & sweep.ppa.meets
    f_idx = _extract_sweep_indices(sweep, np.flatnonzero(feas))
    e_idx = _extract_sweep_indices(sweep, np.flatnonzero(valid))
    return SearchResult(
        spec=sweep.lattice.spec,
        frontier=tuple(sweep.materialize(i) for i in f_idx),
        explored=tuple(sweep.materialize(i) for i in e_idx),
        n_evaluated=int(valid.sum()))


def _sweep_result(sweep: B.BatchedSweep) -> SearchResult:
    """The full-sweep :class:`SearchResult`: ``frontier`` under the public
    sweep semantics (feasible, falling back to all valid points when nothing
    meets timing), ``explored`` the feasibility-blind frontier, and
    ``n_evaluated`` the valid-point count."""
    f_idx = sweep.frontier_indices()
    e_idx = _extract_sweep_indices(sweep, np.flatnonzero(sweep.lattice.valid))
    return SearchResult(
        spec=sweep.lattice.spec,
        frontier=tuple(sweep.materialize(i) for i in f_idx),
        explored=tuple(sweep.materialize(i) for i in e_idx),
        n_evaluated=int(sweep.lattice.valid.sum()))


def _merge_slice_results(lattice: B.DesignLattice,
                         records: Sequence[SearchResult]) -> SearchResult:
    """Merge one record per axis value into the full-sweep result.

    Soundness: a point on the full-lattice frontier is on its own slice's
    frontier (dominance over a subset is implied by dominance over the set),
    so the union of slice frontiers is a superset of the true frontier and
    one pooled extraction recovers it.  Candidates are re-anchored at their
    parent flat index (:meth:`repro_torch.core.batched.DesignLattice.
    index_of_design`) so duplicate collapse picks the same representatives a
    cold full pass would (:func:`repro_torch.core.pareto.merged_pareto_indices`).
    The feasibility fallback composes across slices because slice records
    keep the feasible/valid split explicit (see :func:`_slice_record`)."""
    any_feasible = any(len(r.frontier) for r in records)

    def pool(points_lists) -> tuple:
        pts = [p for ps in points_lists for p in ps]
        parent = [lattice.index_of_design(p.design) for p in pts]
        keep = merged_pareto_indices(parent, _sweep_objectives(pts))
        return tuple(pts[i] for i in keep)

    return SearchResult(
        spec=lattice.spec,
        frontier=pool([r.frontier if any_feasible else r.explored
                       for r in records]),
        explored=pool([r.explored for r in records]),
        n_evaluated=sum(int(r.n_evaluated) for r in records))


_DEFAULT_SERVICE: SynthesisService | None = None
#: Guards the process-wide singleton: the async front makes `get_service`
#: reachable from scheduler threads concurrently with the main thread, and
#: an unlocked check-then-create could hand two callers two different
#: services (split caches, double synthesis).
_SERVICE_LOCK = threading.Lock()


def get_service() -> SynthesisService:
    """The process-wide default service — what `serve.select.select_macros`
    memoizes through, so repeated selections in one process share warm
    frontiers.  Built on the CUDA card, and raises where there is none (a
    CPU caller builds its own ``SynthesisService(device="cpu")``).
    Thread-safe: concurrent callers always observe the same instance."""
    global _DEFAULT_SERVICE
    with _SERVICE_LOCK:
        if _DEFAULT_SERVICE is None:
            _DEFAULT_SERVICE = SynthesisService()
        return _DEFAULT_SERVICE


def reset_service() -> None:
    """Drop the process-wide default service (tests / tech recalibration)."""
    global _DEFAULT_SERVICE
    with _SERVICE_LOCK:
        _DEFAULT_SERVICE = None
