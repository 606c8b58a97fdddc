"""Pareto-frontier utilities (paper §III-C / Fig. 8).

The MSO searcher emits a *set* of design points; the compiler returns those on
the Pareto frontier of (power, area, latency) under the throughput constraint,
"to be finally chosen based on defined PPA preferences or user selection".

Extraction runs in two tiers, both computing the exact same eps-band verdicts
(bit-identical masks, same output order):

  :func:`nondominated_mask`          host numpy, two-phase exact (block-local
                                     prefilter, then every local survivor is
                                     refined against *all* rows);
  :func:`repro_torch.core.batched.pareto_mask`
                                     the same chunked predicate on one torch
                                     device.

The device-sharded map-reduce of the JAX package waits for the port's sharded
slice; :func:`nondominated_mask_auto` is the host mask until then.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, TypeVar

import numpy as np

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
    the batched engine's ``pareto_mask`` on torch tensors on the device.

    The masks are seeded from the first objective's comparison rather than
    allocated, so they land on the operands' device whatever their type."""
    k = blk.shape[1]
    le = all_o[None, :, 0] <= blk[:, None, 0] + eps
    lt = all_o[None, :, 0] < blk[:, None, 0] - eps
    for d in range(1, k):
        le = le & (all_o[None, :, d] <= blk[:, None, d] + eps)
        lt = lt | (all_o[None, :, d] < blk[:, None, d] - eps)
    return (le & lt).any(1)


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


def nondominated_mask_auto(objs, eps: float = PARETO_EPS) -> np.ndarray:
    """The frontier mask for pools of any size.  In the JAX package this
    switches to a device-sharded map-reduce on multi-device hosts; the port's
    sharded slice has not landed, so this is the host mask (same bits)."""
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
    (:func:`repro_torch.core.batched.pareto_mask`) — every mask
    implementation returns the same bits.
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
