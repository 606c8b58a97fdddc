"""Objective sets the eps-band dominance kernel
(``src/repro_torch/csrc/pareto_dominated.cu``) is held to against its plain
version, bit for bit: random sets; near ties whose objectives sit within
+-eps and +-2 eps of one another; duplicates; signed zeros; ``+inf`` pad
rows; NaN entries; every objective count from 1 to 3 and the largest the
kernel takes; candidate and row counts that are not a multiple of the
kernel's block or tile; block-local tests (``seg > 0``); and the
10,000-point two-objective anti-chain, where no point is dominated and
every candidate scans every row.

:func:`dominance_cases` draws them from a numpy seed, so the CPU tests
(``test_torch_compiler_kernels.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py`` share them.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.kernels.pareto_dominated.kernel import MAX_OBJECTIVES


class DominanceCase(NamedTuple):
    name: str
    rows: np.ndarray        # (n, k) float64
    cands: np.ndarray       # (c, k) float64
    seg: int


def _near_ties(rng, n: int, k: int, eps: float) -> np.ndarray:
    """A coarse grid with each coordinate moved by a multiple of eps/2 in
    [-2 eps, 2 eps]: many pairs sit on either side of the band."""
    base = rng.integers(0, 12, (n, k)).astype(np.float64) * 1e-3
    steps = rng.integers(-4, 5, (n, k)).astype(np.float64) * 0.5
    return base + steps * eps


def _tied_front(rng, n: int, eps: float) -> np.ndarray:
    """Three objectives on a few dozen points of an anti-chain (x + y + z
    constant), each drawn many times and moved by multiples of eps/2 in
    [-2 eps, 2 eps]: points of distinct bases never dominate one another,
    so every verdict is decided inside the eps band."""
    xy = rng.integers(0, 8, (n, 2))
    base = np.concatenate([xy, 16 - xy.sum(1, keepdims=True)], axis=1)
    steps = rng.integers(-4, 5, (n, 3)).astype(np.float64) * 0.5
    return base.astype(np.float64) * 1e-3 + steps * eps


def dominance_cases(eps: float, seed: int = 0) -> list[DominanceCase]:
    """The edge sets for the tie band ``eps``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in (1, 2, 3, MAX_OBJECTIVES):
        objs = rng.random((1000, k))
        out.append(DominanceCase(f"random_k{k}", objs, objs, 0))
    rows = rng.random((1000, 3))
    out.append(DominanceCase("ragged_333_of_1000", rows,
                             rng.random((333, 3)), 0))
    ties = _near_ties(rng, 1500, 3, eps)
    out.append(DominanceCase("near_ties", ties, ties, 0))
    front = _tied_front(rng, 1200, eps)
    out.append(DominanceCase("near_ties_front", front, front, 0))
    pairs = _near_ties(rng, 700, 2, eps)
    out.append(DominanceCase("near_ties_k2", pairs, pairs, 0))
    dup = np.repeat(rng.integers(0, 5, (150, 3)).astype(np.float64), 3,
                    axis=0)
    rng.shuffle(dup)
    out.append(DominanceCase("duplicates", dup, dup, 0))
    zeros = rng.choice(np.array([-0.0, 0.0, eps, -eps,
                                 2 * eps, 1.0]), (400, 3))
    out.append(DominanceCase("signed_zeros", zeros, zeros, 0))
    padded = np.concatenate([rng.random((700, 3)),
                             np.full((141, 3), np.inf)])
    out.append(DominanceCase("inf_pad_rows", padded, padded, 0))
    nans = rng.random((600, 3))
    nans[rng.random((600, 3)) < 0.05] = np.nan
    out.append(DominanceCase("nan_entries", nans, nans, 0))
    mixed = np.where(rng.random((500, 3)) < 0.05, np.inf,
                     _near_ties(rng, 500, 3, eps))
    mixed[rng.random((500, 3)) < 0.03] = -np.inf
    out.append(DominanceCase("infinities", mixed, mixed, 0))
    for seg in (64, 100, 1024):
        objs = np.concatenate([_near_ties(rng, 2000, 3, eps),
                               np.full((48, 3), np.inf)])
        out.append(DominanceCase(f"seg_{seg}", objs, objs, seg))
    x = np.linspace(0.0, 1.0, 10_000)
    chain = np.stack([x, 1.0 - x], axis=1)
    out.append(DominanceCase("antichain_10k", chain, chain, 0))
    return out
