"""Pareto-frontier utilities (paper §III-C / Fig. 8).

The MSO searcher emits a *set* of design points; the compiler returns those on
the Pareto frontier of (power, area, latency) under the throughput constraint,
"to be finally chosen based on defined PPA preferences or user selection".

Extraction runs in three tiers, all computing the exact same eps-band
verdicts (bit-identical masks, same output order):

  :func:`nondominated_mask`          host numpy, two-phase exact (block-local
                                     prefilter, then every local survivor is
                                     refined against *all* rows);
  :func:`repro_torch.core.batched.pareto_mask`
                                     the same predicate on one torch device;
  :func:`nondominated_mask_sharded`  map-reduce over the entries of a device
                                     mesh — per-shard local frontier, gather
                                     survivors, refinement against all rows
                                     (lattice-scale frontiers).

The two device tiers test through :func:`dominated`: on a CUDA card the
hand-written kernels (``csrc/pareto_dominated.cu``), for any number of
objectives; on the CPU its plain version, :func:`chunk_dominated` per
chunk.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, TypeVar

import numpy as np
import torch

from ..parallel.sharding import spec_sweep_mesh

T = TypeVar("T")

#: Shared tie/epsilon band for dominance comparisons and duplicate collapse.
#: Every frontier in the repo — the scalar :func:`dominates` /
#: :func:`pareto_indices` path, the batched engine's chunked
#: ``pareto_mask``, and the multi-spec extraction — compares through this one
#: constant, so near-tie objectives land on the *same* frontier no matter
#: which path evaluated them.  The band is absolute: an objective whose scale
#: approaches it (e.g. period in seconds, ~1e-9) effectively gets a relative
#: tolerance.
PARETO_EPS = 1e-12


def dominates(a: Sequence[float], b: Sequence[float],
              eps: float = PARETO_EPS) -> bool:
    """True if objective vector ``a`` Pareto-dominates ``b`` (all <=, one <,
    with the shared ``eps`` tie band).  Objectives are minimized."""
    le = all(x <= y + eps for x, y in zip(a, b))
    lt = any(x < y - eps for x, y in zip(a, b))
    return le and lt


def chunk_dominated(all_o, blk, eps):
    """Eps-band dominance verdicts for one chunk: entry ``i`` is True iff
    some row of ``all_o`` dominates ``blk[i]`` under exactly the
    :func:`dominates` semantics.  This is the *single* implementation of the
    vectorized predicate: :func:`nondominated_mask` runs it on numpy arrays,
    :func:`dominated_ref` on torch tensors.

    The masks are seeded as the reference's are, ``le`` all True and ``lt``
    all False, of the operands' type (numpy or torch) and on their device,
    so that with no objective no row dominates."""
    c, n = blk.shape[0], all_o.shape[0]
    if isinstance(blk, torch.Tensor):
        le = torch.ones((c, n), dtype=torch.bool, device=blk.device)
        lt = torch.zeros((c, n), dtype=torch.bool, device=blk.device)
    else:
        le, lt = np.ones((c, n), dtype=bool), np.zeros((c, n), dtype=bool)
    for d in range(blk.shape[1]):
        le &= all_o[None, :, d] <= blk[:, None, d] + eps
        lt |= all_o[None, :, d] < blk[:, None, d] - eps
    return (le & lt).any(1)


def dominated_ref(rows: torch.Tensor, cands: torch.Tensor,
                  eps: float = PARETO_EPS, seg: int = 0,
                  chunk: int = 512) -> torch.Tensor:
    """Plain version of :func:`dominated`: :func:`chunk_dominated` as torch
    ops, against every row in candidate chunks of ``chunk`` (``seg`` 0),
    or per block of ``seg`` candidates against the same block of rows."""
    if seg:
        if rows.shape[0] != cands.shape[0]:
            raise ValueError(f"seg > 0 tests each candidate against its own "
                             f"block of rows: needs as many rows as "
                             f"candidates, got {rows.shape[0]} and "
                             f"{cands.shape[0]}")
        parts = [chunk_dominated(rows[s:s + seg], cands[s:s + seg], eps)
                 for s in range(0, cands.shape[0], seg)]
    else:
        parts = [chunk_dominated(rows, cands[s:s + chunk], eps)
                 for s in range(0, cands.shape[0], chunk)]
    if not parts:
        return torch.zeros(0, dtype=torch.bool, device=cands.device)
    return torch.cat(parts)


def dominated(rows: torch.Tensor, cands: torch.Tensor,
              eps: float = PARETO_EPS, seg: int = 0,
              chunk: int = 512) -> torch.Tensor:
    """Eps-band dominance verdicts (c,) bool of candidates (c, k) against
    rows (n, k), float64 on one device: entry ``i`` is True iff some row
    dominates ``cands[i]`` under exactly the :func:`dominates` semantics.
    ``seg > 0`` tests candidate ``i`` only against the rows of its own
    block ``[i // seg * seg, i // seg * seg + seg)`` (the sharded mask's
    phase 1; rows and candidates then have one count).

    CPU tensors run the plain version (:func:`dominated_ref`, in chunks of
    ``chunk`` candidates); any other device the CUDA kernels
    (:mod:`repro_torch.kernels.pareto_dominated`), one call for all
    candidates at any number of objectives, or raises: it never falls back
    to the plain version."""
    if rows.device.type == "cpu" and cands.device.type == "cpu":
        return dominated_ref(rows, cands, eps, seg, chunk)
    from ..kernels.pareto_dominated.kernel import pareto_dominated_cuda
    return pareto_dominated_cuda(rows, cands, eps, seg)


def _as_matrix(objs) -> np.ndarray:
    objs = np.asarray(objs, dtype=np.float64)
    if objs.ndim == 1:
        objs = objs[:, None]
    return objs


def nondominated_mask(objs, eps: float = PARETO_EPS,
                      chunk: int = 1024) -> np.ndarray:
    """Boolean non-dominated mask over an (n, k) objective matrix
    (minimization), vectorized and chunked.  Entry ``i`` is True iff no row
    dominates row ``i`` under exactly the :func:`dominates` semantics — this
    is the single dominance predicate :func:`pareto_indices` and the batched
    engine's ``pareto_mask`` both reduce to.

    Runs as a two-phase exact pass: phase 1 tests each block only against
    itself (a point dominated inside its own block is dominated, full stop —
    the witness is a real row), phase 2 refines every local survivor against
    *all* rows.  Because eps-band dominance is not transitive, the refinement
    deliberately compares against every row, not just other survivors; the
    resulting mask is identical to the naive all-pairs pass at a fraction of
    the cost (frontiers are small, so few points reach phase 2)."""
    objs = _as_matrix(objs)
    n = objs.shape[0]
    keep = np.ones(n, dtype=bool)
    if n == 0:
        return keep
    for start in range(0, n, chunk):
        blk = objs[start:start + chunk]                 # (c, k)
        keep[start:start + blk.shape[0]] = ~chunk_dominated(blk, blk, eps)
    survivors = np.flatnonzero(keep)
    for start in range(0, survivors.size, chunk):
        idx = survivors[start:start + chunk]
        keep[idx] = ~chunk_dominated(objs, objs[idx], eps)
    return keep


#: Default device-memory budget for one Pareto chunk's comparison masks.
DEFAULT_PARETO_BUDGET_BYTES = 256 * 1024 * 1024


def pareto_chunk_size(n_points: int, n_objectives: int = 3,
                      budget_bytes: int = DEFAULT_PARETO_BUDGET_BYTES) -> int:
    """Chunk size for the chunked Pareto masks such that the peak comparison
    footprint fits the accelerator budget.

    One chunk row holds the ``le``/``lt`` masks plus one comparison temp per
    objective against all ``n_points`` columns (~1 byte each), so a chunk
    costs about ``chunk * n_points * (2 + n_objectives)`` bytes."""
    per_row = max(1, n_points) * (2 + max(1, n_objectives))
    chunk = budget_bytes // per_row
    return int(min(max(chunk, 64), max(n_points, 64)))


# ---------------------------------------------------------------------------
# Mesh-sharded extraction (lattice-scale frontiers)
# ---------------------------------------------------------------------------

#: Below this point count the host pass wins on dispatch overhead; the auto
#: dispatcher only reaches for devices at or above it.
SHARDED_EXTRACT_MIN_POINTS = 8192


def nondominated_mask_sharded(objs, eps: float = PARETO_EPS,
                              chunk: int | None = None,
                              mode: str = "auto", mesh=None) -> np.ndarray:
    """Mesh-sharded :func:`nondominated_mask`: the map-reduce dominance pass
    for lattice-scale frontiers.

    The rows are split into one contiguous shard per mesh entry (padded
    with ``+inf``) and the verdict is computed in two exact phases, both
    through :func:`dominated` on each entry's device (the CUDA kernel on a
    card, the plain version on the CPU):

      1. *per-shard local prefilter* — each shard's rows in blocks of
         ``chunk`` (default ``max(64, min(1024, rows per shard))``), each
         block tested against itself (``seg=chunk``, one call per shard);
         a row dominated inside its own block is dominated, full stop (the
         witness is a real row).  Each shard is copied to its device once;
         every ``mode`` (validated by the engine's
         :func:`repro_torch.core.engine.resolve_sharded_mode`) runs this
         one pass over every entry of ``mesh``;
      2. *cross-shard refinement* — the local survivors, split into one
         contiguous ``+inf``-padded slice per entry, are re-tested against
         **all** rows, replicated on each entry's device (one call per
         entry; the plain version walks its slice in chunks sized to the
         entry's share of the memory budget).  Eps-band dominance is not
         transitive, so testing survivors only against other survivors
         would not be exact; testing against every row is.

    Every entry's work is issued before any verdict is copied back, so
    entries on distinct cards overlap.  An ``+inf`` row never dominates a
    finite one, and pad verdicts are dropped before they are read.  The
    result is bit-identical to the host :func:`nondominated_mask` — same
    :data:`PARETO_EPS` band, same verdict per row, same output order — on
    one entry and on N; only the wall-clock changes.

    ``mesh`` is the device mesh to shard over — pass the mesh a sweep
    evaluated on so extraction uses the same entries; default is every
    visible CUDA card (:func:`repro_torch.parallel.sharding.
    spec_sweep_mesh`, an error where there is none)."""
    objs = _as_matrix(objs)
    n, k = objs.shape
    if n == 0:
        return np.ones(0, dtype=bool)
    from . import engine as E          # lazy: engine imports this module
    E.resolve_sharded_mode(mode)       # validate; every mode runs one pass
    if mesh is None:
        mesh = spec_sweep_mesh()
    devices = list(mesh.devices.flat)
    n_dev = len(devices)
    m = -(-n // n_dev)                               # rows per shard
    c = int(chunk) if chunk else max(64, min(1024, m))
    m_p = -(-m // c) * c                             # whole blocks
    pad_rows = m_p * n_dev - n
    padded = (np.concatenate([objs, np.full((pad_rows, k), np.inf)])
              if pad_rows else objs)
    shards = padded.reshape(n_dev, m_p, k)

    def put(a, dev):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    parts = []
    for d, dev in enumerate(devices):
        shard = put(shards[d], dev)
        parts.append(dominated(shard, shard, eps, seg=c))
    out = np.concatenate([p.cpu().numpy() for p in parts])[:n]

    survivors = np.flatnonzero(~out)
    rows = {}                                        # replicated per device
    for dev in devices:
        if dev not in rows:
            rows[dev] = put(objs, dev)
    # plain version's survivor chunks sized so each entry's comparison
    # masks fit its slice of the memory budget
    cr = max(64, pareto_chunk_size(
        n, k, DEFAULT_PARETO_BUDGET_BYTES // n_dev))
    per = -(-survivors.size // n_dev)                # survivors per entry
    blk = objs[survivors]
    if per * n_dev > blk.shape[0]:                   # whole slices
        blk = np.concatenate(
            [blk, np.full((per * n_dev - blk.shape[0], k), np.inf)])
    blk = blk.reshape(n_dev, per, k)
    verdicts = [dominated(rows[dev], put(blk[d], dev), eps, chunk=cr)
                for d, dev in enumerate(devices)]
    verdict = np.concatenate([v.cpu().numpy() for v in verdicts])
    out[survivors] = verdict[:survivors.size]
    return ~out


def nondominated_mask_auto(objs, eps: float = PARETO_EPS) -> np.ndarray:
    """Host mask below the sharding payoff point (or with fewer than two
    CUDA cards), the mesh-sharded map-reduce over every card above it.
    Both produce the same bits, so callers may switch freely on scale."""
    objs = _as_matrix(objs)
    if objs.shape[0] >= SHARDED_EXTRACT_MIN_POINTS:
        # Only the device probe is guarded: a failure *inside* the sharded
        # pass (device OOM, a sharding regression) must surface, not
        # silently degrade to the slow host walk.
        try:
            n_dev = torch.cuda.device_count()
        except RuntimeError:
            n_dev = 1
        if n_dev > 1:
            return nondominated_mask_sharded(objs, eps)
    return nondominated_mask(objs, eps)


def pareto_indices(objs: Sequence[Sequence[float]],
                   mask_fn: Callable[[np.ndarray], np.ndarray] | None = None
                   ) -> list[int]:
    """Indices of the non-dominated, deduplicated members of ``objs``, sorted
    by objective tuple.  This is the single source of truth for frontier
    semantics: :func:`pareto_front` and the batched engine's vectorized
    extraction both reduce to it, so scalar and batched sweeps agree exactly.

    Dominance testing delegates to the vectorized :func:`nondominated_mask`
    (the per-pair Python walk was O(N^2) and hung at lattice scale); callers
    at lattice scale may pass the device mask
    (:func:`repro_torch.core.batched.pareto_mask`),
    ``mask_fn=nondominated_mask_auto`` or the sharded mask directly — every
    mask implementation returns the same bits.
    The documented output order is preserved exactly: near-duplicates (all
    coordinates within :data:`PARETO_EPS`) keep their first occurrence in
    input order, and the surviving set is sorted by objective tuple."""
    objs = list(objs)
    if not objs:
        return []
    arr = np.asarray([[float(x) for x in o] for o in objs], dtype=np.float64)
    survivors = np.flatnonzero((mask_fn or nondominated_mask)(arr))
    # Dedup in input order against the accepted set (vectorized per survivor,
    # matching the incremental semantics of the original Python walk).
    acc = np.empty((survivors.size, arr.shape[1]), dtype=np.float64)
    n_acc = 0
    front: list[tuple[Sequence[float], int]] = []
    for i in survivors:
        o = arr[i]
        if n_acc and (np.abs(acc[:n_acc] - o) < PARETO_EPS).all(axis=1).any():
            continue
        acc[n_acc] = o
        n_acc += 1
        front.append((objs[i], int(i)))
    front.sort(key=lambda oi: tuple(oi[0]))
    return [i for _, i in front]


def merged_pareto_indices(parent_idx: Sequence[int],
                          objs: Sequence[Sequence[float]],
                          mask_fn: Callable[[np.ndarray], np.ndarray]
                          | None = None) -> list[int]:
    """:func:`pareto_indices` over a pool assembled from several lattice
    *slices* (the incremental re-synthesis merge): candidate ``i`` carries the
    flat index ``parent_idx[i]`` of the design point in the parent lattice.

    Rows are visited in ascending parent-flat-index order before extraction,
    so the near-duplicate collapse keeps the *same representative* a cold
    full-lattice pass would keep (that pass visits points in flat order) — no
    matter how the pool was partitioned into slices or in which order the
    slices arrived.  Returns positions into the pool as given, frontier
    sorted by objective tuple, exactly like :func:`pareto_indices`.  A pool
    whose slices are disjoint in parent index (the incremental contract)
    therefore merges bit-identically to extracting the union in one pass."""
    parent_idx = np.asarray(parent_idx, dtype=np.int64)
    objs = list(objs)
    if len(parent_idx) != len(objs):
        raise ValueError("parent_idx must match objs one-to-one")
    order = np.argsort(parent_idx, kind="stable")
    picked = pareto_indices([objs[int(j)] for j in order], mask_fn=mask_fn)
    return [int(order[p]) for p in picked]


def pareto_front(items: Iterable[T], objectives: Callable[[T], Sequence[float]]
                 ) -> list[T]:
    """Filter ``items`` to the non-dominated set, stably ordered by the first
    objective."""
    items = list(items)
    objs = [objectives(it) for it in items]
    return [items[i] for i in pareto_indices(objs)]


def scalarize(weights: Sequence[float], objectives: Sequence[float],
              refs: Sequence[float]) -> float:
    """Weighted-sum scalarization with reference normalization (used to pick a
    single design for a PPA preference)."""
    return sum(w * (o / max(r, 1e-30))
               for w, o, r in zip(weights, objectives, refs))


def preference_grid(resolution: int = 4) -> list[tuple[float, float, float]]:
    """Deterministic simplex grid over (power, area, throughput) preference
    weights — the multi-spec sweep driving the searcher.

    ``resolution`` must be >= 1: a 0-resolution grid would be empty and every
    sweep built on it would silently synthesize nothing."""
    if resolution < 1:
        raise ValueError(
            f"preference_grid needs resolution >= 1, got {resolution}: an "
            "empty grid silently yields empty sweeps downstream")
    out = []
    for a in range(resolution + 1):
        for b in range(resolution + 1 - a):
            c = resolution - a - b
            if a == b == c == 0:
                continue
            out.append((a / resolution, b / resolution, c / resolution))
    return out
