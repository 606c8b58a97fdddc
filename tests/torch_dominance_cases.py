"""Objective sets the eps-band dominance kernel
(``src/repro_torch/csrc/pareto_dominated.cu``) is held to against its plain
version, bit for bit: random sets; near ties whose objectives sit within
+-eps and +-2 eps of one another; duplicates; signed zeros; ``+inf`` pad
rows; NaN entries; every objective count from 1 to 3 and the largest the
kernel takes; candidate and row counts that are not a multiple of the
kernel's block or tile; block-local tests (``seg > 0``); and the
10,000-point two-objective anti-chain, where no point is dominated and
every candidate scans every row.

Then sets shaped for the kernel's two passes (a screen pass that tests each
candidate against at most ``SCREEN_ROWS`` rows, spread over the array where
it is longer, and a split pass that tests the candidates it leaves against
every row, in chunks of ``chunk_rows(k)`` rows): one point nothing dominates
among many dominated ones; a witness only in the last row; each candidate's
only witness exactly at a screen-sample, screen-budget, chunk or last row,
for two, three and eight objectives; every candidate left to the split
pass; n not a multiple of the chunk; n = 1 and c = 1; ``seg`` blocks
shorter than, equal to and longer than the screen budget (with witnesses
on either side of it); ``+inf`` pad candidates and NaN candidates that the
screen leaves to the split pass.

Then sets for the wide kernel, which takes any other objective count
(more than ``MAX_OBJECTIVES``, or none), drawn from a generator of their
own after the others, so that the earlier sets keep their data: random
sets at 9, 12, 16 and 64 objectives, near ties at 12, each candidate's
only witness at a boundary row at 12, block-local tests at 12, and no
objective at all (every verdict False).  :func:`wide_tie_points` draws a
larger set of near ties at any objective count.

Then sets for the wide kernels' two passes (a wide screen against at most
``screen_rows(k)`` rows, and a wide split in chunks of ``chunk_rows(k)``
rows: staged up to ``WIDE_STAGE`` objectives, read in place above), from a
third generator: each candidate's only witness at a sampled row, the
screen budget, every chunk (and so every partition) start and end of the
split and the last row, at 9 and 64 objectives (where the screen's budget
is shorter) and at 80, past the staging limit;
``seg`` blocks longer than the budget whose candidates' only witnesses sit
on every chunk boundary of their block, at 12 and 80; and points on the
simplex at 80 objectives with others each moved up from one of them, where
both verdicts occur and the screen leaves survivors to the split.

:func:`dominance_cases` draws them from a numpy seed, so the CPU tests
(``test_torch_compiler_kernels.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py`` share them.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.kernels.pareto_dominated.kernel import (MAX_OBJECTIVES,
                                                         SCREEN_ROWS,
                                                         WIDE_STAGE,
                                                         screen_rows)

#: The wide kernels' chunks: float64 values per staged chunk buffer
#: (``kWideChunk`` in the source), and rows per chunk where the rows are
#: read in place (``kWideRows``).
WIDE_CHUNK, WIDE_ROWS = 4096, 256


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


def _wide_ties(rng, n: int, k: int, eps: float) -> np.ndarray:
    """Objectives on a grid of three values (many exact ties, and at 12
    objectives some hundreds of points in 8,192 that nothing dominates),
    each jittered inside the +-eps/2 band on half the coordinates."""
    base = rng.integers(0, 3, (n, k)).astype(np.float64) * 1e-3
    jitter = rng.uniform(-0.5, 0.5, (n, k)) * eps
    jitter[rng.random((n, k)) < 0.5] = 0.0
    return base + jitter


def wide_tie_points(n: int, k: int, eps: float, seed: int) -> np.ndarray:
    """``n`` near-tie points at ``k`` objectives drawn from ``seed``: both
    verdicts occur in the hundreds or more at n = 8,192 and k = 12."""
    return _wide_ties(np.random.default_rng(seed), n, k, eps)


def chunk_rows(k: int) -> int:
    """Rows per chunk of the split pass for 1 to ``MAX_OBJECTIVES``
    objectives (``chunk_rows<K>()`` in the source), and of both wide passes
    for more (``wide_chunk_rows``): whole warps of as many rows as
    ``WIDE_CHUNK`` values hold up to ``WIDE_STAGE`` objectives, else
    ``WIDE_ROWS``."""
    if k <= MAX_OBJECTIVES:
        return 1024 if k <= 4 else 512
    return WIDE_CHUNK // k // 32 * 32 if k <= WIDE_STAGE else WIDE_ROWS


def _chunk_ends(chunk: int, stop: int) -> set[int]:
    """The first and last row of every chunk boundary in [chunk, stop)."""
    return {r for m in range(chunk, stop, chunk) for r in (m - 1, m)}


def boundary_rows(n: int, k: int, seg: int = 0) -> list[int]:
    """The rows a test of ``n`` rows (or of a ``seg`` block) starts, ends or
    changes hands at: the screen's sampled rows and budget
    (``screen_rows(k)``), the split pass's chunks, the last row.  For the
    wide kernels (more than ``MAX_OBJECTIVES`` objectives) every chunk
    start and end of the wide split, whose partitions are whole chunks."""
    chunk, budget = chunk_rows(k), screen_rows(k)
    wide = k > MAX_OBJECTIVES
    if seg:
        out = {budget - 1, budget, chunk - 1, chunk, seg - 1}
        return sorted(out | _chunk_ends(chunk, seg) if wide else out)
    stride = max(1, n // budget)
    out = {0, stride, budget - 1, budget, chunk - 1, chunk, 2 * chunk - 1,
           2 * chunk, (budget - 1) * stride, (budget - 1) * stride + 1,
           n - 1}
    if wide:
        out |= _chunk_ends(chunk, n)
    return sorted(r for r in out if 0 <= r < n)


def _sole_witnesses(n: int, k: int, at: list[int]) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """Rows (n, k) and one candidate per entry of ``at``, whose only
    witness is row ``at[j]``: the candidates lie on an anti-chain of the
    first two objectives (the others 0.5), each witness is its candidate
    moved down the first objective by less than the spacing, and every
    other row (+10 everywhere) dominates nothing."""
    x = np.linspace(0.1, 0.9, len(at))
    cands = np.full((len(at), k), 0.5)
    cands[:, 0], cands[:, 1] = x, 1.0 - x
    rows = np.full((n, k), 10.0)
    rows[at] = cands
    rows[at, 0] -= 0.25 * (x[1] - x[0]) if len(at) > 1 else 0.1
    return rows, cands


def _two_pass_cases(rng, eps: float) -> list[DominanceCase]:
    out = []
    # one point nothing dominates (it dominates every other point) among
    # 6,000 random ones, at a row the screen does not sample
    objs = rng.random((6000, 3))
    objs[3777] = -1.0
    out.append(DominanceCase("lone_front", objs, objs, 0))
    # 300 candidates whose only witness is the last of 3,001 rows
    rows = np.full((3001, 3), 10.0)
    rows[-1] = 0.0
    out.append(DominanceCase("witness_last_row", rows,
                             0.5 + 0.5 * rng.random((300, 3)), 0))
    # each candidate's only witness at a boundary row
    for n, k in ((5000, 2), (4100, 3), (2600, MAX_OBJECTIVES)):
        rows, cands = _sole_witnesses(n, k, boundary_rows(n, k))
        out.append(DominanceCase(f"boundary_witnesses_k{k}", rows, cands, 0))
    # every candidate left to the split pass: 5,000 points on the plane
    # x + y + z = 1, none dominating another
    plane = rng.dirichlet(np.ones(3), 5000)
    out.append(DominanceCase("plane_5k", plane, plane, 0))
    # one row and one candidate
    one = rng.random((1, 3))
    out.append(DominanceCase("n1_c1_same", one, one, 0))
    out.append(DominanceCase("n1_c1_dominated", one, one + 0.5, 0))
    # seg blocks shorter than, equal to and longer than the screen budget
    for seg in (SCREEN_ROWS // 2, SCREEN_ROWS, SCREEN_ROWS + 476):
        objs = np.concatenate([_near_ties(rng, 3 * seg + 211, 3, eps),
                               np.full((seg - 211, 3), np.inf)])
        out.append(DominanceCase(f"seg_{seg}_budget", objs, objs, seg))
    # a seg block longer than the budget whose candidates' only witnesses
    # sit on either side of it: block j holds candidate j of an anti-chain
    # at row 5 and its witness at boundary row at[j] of the block, the
    # other rows +10 (dominated by both)
    seg = SCREEN_ROWS + 476
    at = boundary_rows(seg, 3, seg)
    witnesses, cands = _sole_witnesses(seg, 3, at)
    blocks = []
    for j, w in enumerate(at):
        blk = np.full((seg, 3), 10.0)
        blk[w], blk[5] = witnesses[w], cands[j]
        blocks.append(blk)
    objs = np.concatenate(blocks)
    out.append(DominanceCase("seg_boundary_witnesses", objs, objs, seg))
    # a whole test of 1,000 rows whose candidates' only witnesses sit at
    # every row, so that a warp's open candidates meet theirs anywhere in
    # the screen's tail, and 24 candidates that nothing dominates
    rows, cands = _sole_witnesses(1000, 3, list(range(1000)))
    cands = np.concatenate([cands, np.zeros((24, 3))])
    out.append(DominanceCase("tail_witnesses", rows, cands, 0))
    # +inf pad candidates the screen leaves: every sampled row is +inf
    rows = np.full((3000, 3), np.inf)
    rows[[1501, 2999]] = rng.random((2, 3))
    cands = np.concatenate([np.full((200, 3), np.inf),
                            rng.random((100, 3))])
    out.append(DominanceCase("inf_pad_survivors", rows, cands, 0))
    # NaN in candidates that go on to the split pass
    rows = rng.random((3000, 3))
    cands = rng.random((100, 3))
    cands[np.arange(0, 100, 2), rng.integers(0, 3, 50)] = np.nan
    out.append(DominanceCase("nan_survivors", rows, cands, 0))
    return out


def _wide_cases(rng, eps: float) -> list[DominanceCase]:
    out = []
    for k in (9, 12, 16, 64):
        objs = rng.random((1000, k))
        out.append(DominanceCase(f"random_k{k}", objs, objs, 0))
    ties = _wide_ties(rng, 1500, 12, eps)
    out.append(DominanceCase("near_ties_k12", ties, ties, 0))
    rows, cands = _sole_witnesses(2600, 12, boundary_rows(2600, 12))
    out.append(DominanceCase("boundary_witnesses_k12", rows, cands, 0))
    objs = np.concatenate([_wide_ties(rng, 1111, 12, eps),
                           np.full((89, 12), np.inf)])
    out.append(DominanceCase("seg_300_k12", objs, objs, 300))
    none = np.zeros((700, 0))
    out.append(DominanceCase("k0", none, none, 0))
    return out


def _simplex_parents(rng, n: int, k: int) -> np.ndarray:
    """A third of ``n`` points on the simplex (sum 1: none dominates
    another), and the rest each one of them moved up by up to 0.01 in every
    objective (dominated by it, and by some other simplex points), shuffled:
    both verdicts occur in the hundreds at any objective count."""
    front = rng.dirichlet(np.ones(k), n // 3)
    moved = (front[rng.integers(0, len(front), n - len(front))]
             + rng.uniform(1e-4, 1e-2, (n - len(front), k)))
    objs = np.concatenate([front, moved])
    rng.shuffle(objs)
    return objs


def _seg_witness_blocks(seg: int, k: int, blocks: int) -> np.ndarray:
    """``blocks`` blocks of ``seg`` rows, each holding the candidates of
    :func:`_sole_witnesses` on its first rows off the boundaries and their
    only witnesses on ``boundary_rows(seg, k, seg)``, the other rows +10
    (dominated by both)."""
    at = boundary_rows(seg, k, seg)
    blk, cands = _sole_witnesses(seg, k, at)
    blk[[r for r in range(seg) if r not in set(at)][:len(at)]] = cands
    return np.concatenate([blk] * blocks)


def _wide_split_cases(rng) -> list[DominanceCase]:
    out = []
    for k in (9, WIDE_STAGE, 80):
        rows, cands = _sole_witnesses(2600, k, boundary_rows(2600, k))
        out.append(DominanceCase(f"boundary_witnesses_k{k}", rows, cands, 0))
    for k in (12, 80):
        objs = _seg_witness_blocks(SCREEN_ROWS + 476, k, 2)
        out.append(DominanceCase(f"seg_boundary_witnesses_k{k}", objs, objs,
                                 SCREEN_ROWS + 476))
    objs = _simplex_parents(rng, 2400, 80)
    out.append(DominanceCase("simplex_k80", objs, objs, 0))
    return out


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
    return (out + _two_pass_cases(rng, eps)
            + _wide_cases(np.random.default_rng(seed + 1), eps)
            + _wide_split_cases(np.random.default_rng(seed + 2)))
