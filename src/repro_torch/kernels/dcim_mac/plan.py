"""How a ``dcim_mac`` call is cut up on the card: its route and, on the TMA
route, its strips and K splits.  Pure functions of the shape (and, for the
route, of the operands' alignment), so the CPU tests hold them to their
contract.

Routes (the JAX package's route names):

  * ``pipelined`` — the Hopper kernel: ``wgmma`` fed by TMA through a
    ``depth``-stage mbarrier ring (``csrc/dcim_mac.cu``,
    ``dcim_mac_tma``).  TMA needs 16-byte aligned base addresses and row
    strides, so A's rows (K bytes) and W's rows (N bytes) must be
    multiples of 16 and both operands must start on a 16-byte boundary.
    Fewer tokens than one ``wgmma`` tile (:data:`TMA_MIN_ROWS`) also take
    the other route, as the route contract asks; on an H100 the TMA route
    was the faster one there too at K 2560, N 4096 (``PERF.md``).
  * ``grid`` — the ``mma.sync`` kernel of 64 x 64 tiles for everything
    else (ragged rows, a view that starts off a 16-byte boundary, fewer
    than 64 rows).  It masks every edge itself.

The rule looks at shape and alignment only, never at whether a launch
succeeds.

On the TMA route one block owns a strip of :data:`BN` columns of W and
all tokens of a :data:`BM`-token strip of A (M > 256 is cut into 256-token
strips), and walks a range of K in :data:`BK`-deep stages.  Narrow GEMMs
have too few strips to fill the card, so K is split over a cluster of
``splits`` blocks whose int32 partials are summed through distributed
shared memory by the cluster itself (:func:`mac_plan`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..tiles import DEFAULT_TILES

#: The TMA kernel's block: tokens, W columns, K depth of one stage.
BM, BN, BK = (DEFAULT_TILES["dcim_mac"].bm, DEFAULT_TILES["dcim_mac"].bn,
              DEFAULT_TILES["dcim_mac"].bk)

#: Rows of one ``wgmma`` tile: shorter A strips take the grid route.
TMA_MIN_ROWS = 64

#: Alignment TMA needs of a base address and a row stride, in bytes.
TMA_ALIGN = 16

#: Blocks of the TMA kernel an H100 SXM runs at once, by cluster size:
#: one block per SM (its ring takes most of the shared memory), and a
#: cluster stays inside one GPC, so clusters of 4 and 8 leave 12 of the
#: 132 SMs idle (``cudaOccupancyMaxActiveClusters``: 132, 66, 30 and 15
#: clusters at every depth; ``probes/mac_tma.py``).  Its keys are the
#: cluster sizes the K split may take (powers of two up to the portable
#: limit).
SLOTS = {1: 132, 2: 132, 4: 120, 8: 120}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mac_route(m: int, k: int, n: int, a_ptr: int = 0, w_ptr: int = 0
              ) -> str:
    """``pipelined`` (the TMA kernel) or ``grid`` (the ``mma.sync``
    kernel) for an (m, k) @ (k, n) product whose operands start at byte
    addresses ``a_ptr`` and ``w_ptr``."""
    aligned = (k > 0 and k % TMA_ALIGN == 0 and n % TMA_ALIGN == 0
               and a_ptr % TMA_ALIGN == 0 and w_ptr % TMA_ALIGN == 0)
    return "pipelined" if aligned and m >= TMA_MIN_ROWS else "grid"


@dataclass(frozen=True)
class MacPlan:
    """The TMA route's grid: ``m_strips`` x ``n_strips`` output tiles, each
    computed by a cluster of ``splits`` blocks over K.  Split z walks the
    ``BK``-deep stages ``stage_ranges[z]``."""

    m: int
    k: int
    n: int
    m_strips: int
    n_strips: int
    splits: int

    @property
    def stages(self) -> int:
        return _cdiv(self.k, BK)

    @property
    def blocks(self) -> int:
        return self.m_strips * self.n_strips * self.splits

    @property
    def stage_ranges(self) -> list[tuple[int, int]]:
        """Split z's stages [begin, end): ``floor(z T / S)`` on, so the
        splits differ by at most one stage (the kernel computes the
        same)."""
        t, s = self.stages, self.splits
        return [(z * t // s, (z + 1) * t // s) for z in range(s)]

    @property
    def k_ranges(self) -> list[tuple[int, int]]:
        """Split z's K range in elements: multiples of ``BK`` except for
        the last, which ends at K."""
        return [(b * BK, min(e * BK, self.k)) for b, e in self.stage_ranges]


#: A block's fixed cost beyond its stages, in stages: the ring's first
#: loads and the epilogue; with a K split also the partials' round trip
#: through shared memory and the cluster's two barriers.  Fitted to the
#: times of every split of the six qwen3-4b GEMMs on an H100
#: (``probes/mac_tma.py``).
FIXED_STAGES = {1: 2, 2: 5, 4: 5, 8: 5}


def mac_plan(m: int, k: int, n: int) -> MacPlan:
    """The strips and K splits of an (m, k) @ (k, n) product on the TMA
    route.  The split count S (a cluster size in :data:`SLOTS`, at most
    the stage count) minimises a block's stages plus its fixed cost
    (:data:`FIXED_STAGES`) times the waves of blocks,
    ``(ceil(T / S) + FIXED_STAGES[S]) * ceil(blocks / SLOTS[S])``; ties go
    to the fewer splits."""
    m_strips, n_strips = _cdiv(m, BM), _cdiv(n, BN)
    tiles = m_strips * n_strips
    stages = _cdiv(k, BK)
    best = None
    for s, slots in SLOTS.items():
        if s > max(stages, 1):
            break
        cost = ((_cdiv(stages, s) + FIXED_STAGES[s])
                * _cdiv(tiles * s, slots))
        if best is None or cost < best[0]:
            best = (cost, s)
    return MacPlan(m, k, n, m_strips, n_strips, best[1])
