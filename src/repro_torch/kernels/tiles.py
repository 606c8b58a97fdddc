"""Tile/pipeline configuration shared by the port's three CUDA kernels.

A :class:`TileConfig` names every tunable of one kernel launch: the block
shape the grid is cut into and the pipeline ``depth``.  It keeps the JAX
package's meaning, so a tuned posture reads the same in both packages; the
tile autotuner (:mod:`repro_torch.kernels.autotune`) enumerates candidates
from :func:`tile_space`, times them and keeps the winner.

Field semantics per kernel (unused fields stay None):

  dcim_mac   bm tokens x bn W columns of the TMA kernel's block, bk K
             stage, depth stages in its TMA / mbarrier ring
  ssm_scan   bt T-chunk, bd D-tile (one thread per column), depth cp.async
             stages of (a, b) chunks (1: the plain-load kernel)
  csa_tree   bh row tile (the tiled-H kernel), bn columns (one thread each)

Feasibility is Hopper's, not the TPU's: a block's working set must fit the
shared memory one block may use (:data:`SMEM_BUDGET_BYTES` in place of the
TPU's 12 MiB VMEM budget), and a dimension that maps onto threads is a
multiple of the warp (:data:`WARP` in place of the TPU's 128-lane and
8-sublane alignment).  The working set of a candidate is the port kernel's
own shared-memory use (:func:`smem_bytes`).  The ``csa_tree`` register
kernel uses none: its tile of bh rows lives in registers; bh is capped by
:data:`CSA_REG_ROWS` and bn by the kernel's launch bound
:data:`CSA_THREADS`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: Shared memory one block may use on an H100: 227 KB of the SM's 256 KB.
#: Above 48 KB it is dynamic shared memory, which the kernels' launchers
#: unlock with ``cudaFuncSetAttribute``.
SMEM_BUDGET_BYTES = 232_448

#: Threads of a warp: every tile dimension that maps onto threads is a
#: multiple of it.
WARP = 32

#: Threads one block may have.
MAX_THREADS = 1024

#: Ring depths (A stages in flight) the ``dcim_mac`` TMA kernel is
#: compiled for, and its fixed count of raw and of transposed W stages.
MAC_DEPTHS = (2, 3, 4)
MAC_W_BUFS = 3

#: Pipeline depths the ``ssm_scan`` kernel is compiled for (1 is the
#: plain-load kernel, 2..4 the ``cp.async`` ring).
SSM_DEPTHS = (1, 2, 3, 4)

#: Rows of the ``csa_tree`` whole-rows route, the JAX package's bound: the
#: register kernel generated for H rows runs every stack of at most this
#: many rows whole.
CSA_MAX_ROWS = 512

#: Tallest tile of the ``csa_tree`` tiled route (``bh``): the register
#: kernel generated for bh rows walks H in bh-row tiles.  Taller tiles
#: build as well (the rows route runs up to :data:`CSA_MAX_ROWS`), but no
#: gain from one was measured, so the autotuner's space stops here.
CSA_REG_ROWS = 128

#: Threads a block of the ``csa_tree`` register kernel may have (its
#: ``__launch_bounds__``, so the 128-row kernel may take up to 255
#: registers a thread).
CSA_THREADS = 256


@dataclass(frozen=True)
class TileConfig:
    """One kernel launch posture.  Hashable; ``None`` fields mean "not
    meaningful for this kernel"."""

    bm: int | None = None
    bn: int | None = None
    bk: int | None = None
    bt: int | None = None
    bd: int | None = None
    bh: int | None = None
    depth: int = 2

    def as_dict(self) -> dict[str, int]:
        """Only the set fields, for artifact payloads and bench rows."""
        out = {k: v for k, v in dataclasses.asdict(self).items()
               if v is not None and k != "depth"}
        out["depth"] = self.depth
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TileConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in fields})


#: Per-kernel default launch posture of the Hopper kernels.  Where it
#: differs from the JAX package's TPU default:
#:
#:   dcim_mac  256 tokens x 128 columns x 128-deep stages, a four-stage
#:             TMA ring: the block ``csrc/dcim_mac.cu``'s TMA kernel is
#:             compiled for (TPU: 128 x 128 x 128, two slots); the grid
#:             route's ``mma.sync`` kernel has one 64 x 64 block of its own;
#:   ssm_scan  bt 32 (TPU: 128): two stages of 128-row (a, b) chunks of
#:             128 columns would need 256 KiB of shared memory;
#:   csa_tree  bh 128 / bn 256 (the TPU's): the register kernel's largest
#:             tile; on an H100, 256-thread blocks ran the 2560-row
#:             qwen3-4b wk product stack 1.7% faster than 128-thread
#:             ones and a 64-row chunk as fast (``probes/csa_stage.py``).
DEFAULT_TILES: dict[str, TileConfig] = {
    "dcim_mac": TileConfig(bm=256, bn=128, bk=128, depth=4),
    "ssm_scan": TileConfig(bt=32, bd=128, depth=2),
    "csa_tree": TileConfig(bh=128, bn=256, depth=1),
}

KERNELS = tuple(DEFAULT_TILES)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shape_class(kernel: str, shape: tuple[int, ...]) -> str:
    """Bucket a concrete shape so one tuning generalizes: every dim rounds
    up to the next power of two (decode M=1..128 share a class, long-context
    T=400k..524k share a class)."""
    def pow2(x: int) -> int:
        p = 1
        while p < x:
            p *= 2
        return p
    return f"{kernel}:" + "x".join(str(pow2(max(1, int(d)))) for d in shape)


def smem_bytes(kernel: str, cfg: TileConfig) -> int:
    """Shared memory one block of the port's kernel uses under ``cfg``."""
    if kernel == "dcim_mac":
        # 1 KB to align the 128-byte swizzle's atoms, the ring of `depth`
        # A stages, MAC_W_BUFS raw and as many transposed W stages, and two
        # mbarriers (8 bytes each: full, empty) per stage of each
        return (1024 + cfg.depth * cfg.bm * cfg.bk
                + 2 * MAC_W_BUFS * cfg.bk * cfg.bn
                + 8 * 2 * (cfg.depth + 2 * MAC_W_BUFS))
    if kernel == "ssm_scan":
        return 4 * 2 * cfg.depth * cfg.bt * cfg.bd
    if kernel == "csa_tree":
        return 0
    raise ValueError(f"unknown kernel {kernel!r}; have {KERNELS}")


def _threads_ok(n: int | None) -> bool:
    return n is not None and n % WARP == 0 and WARP <= n <= MAX_THREADS


def feasible(kernel: str, cfg: TileConfig) -> bool:
    """Whether the port's kernel can launch with ``cfg`` on Hopper."""
    if kernel == "dcim_mac":
        block = dataclasses.replace(cfg, depth=DEFAULT_TILES[kernel].depth)
        ok = block == DEFAULT_TILES[kernel] and cfg.depth in MAC_DEPTHS
    elif kernel == "ssm_scan":
        ok = (cfg.bt is not None and cfg.bt >= 1 and _threads_ok(cfg.bd)
              and cfg.depth in SSM_DEPTHS)
    elif kernel == "csa_tree":
        # depth has no meaning for the adder tree (the JAX package's
        # configs carry any value there)
        ok = (cfg.bh is not None and 1 <= cfg.bh <= CSA_REG_ROWS
              and _threads_ok(cfg.bn) and cfg.bn <= CSA_THREADS)
    else:
        raise ValueError(f"unknown kernel {kernel!r}; have {KERNELS}")
    return ok and smem_bytes(kernel, cfg) <= SMEM_BUDGET_BYTES


def _clamp(cands: tuple[int, ...], dim: int, align: int) -> list[int]:
    """Candidate tile sizes for one dimension: a tile larger than the
    dimension's aligned extent only covers padding, so it is pruned."""
    ceil = max(align, round_up(dim, align))
    keep = sorted({min(c, ceil) for c in cands})
    return [c for c in keep if c <= ceil]


def tile_space(kernel: str, shape: tuple[int, ...]) -> list[TileConfig]:
    """The candidate (block-shape, depth) lattice for one kernel on one
    concrete shape: no tile past the aligned extent, every candidate
    :func:`feasible` on Hopper, the default first when it survives."""
    out: list[TileConfig] = []
    if kernel == "dcim_mac":
        # the kernel masks ragged edges itself: its one block serves every
        # (M, K, N); the ring depths it is compiled for
        out += [dataclasses.replace(DEFAULT_TILES["dcim_mac"], depth=d)
                for d in MAC_DEPTHS]
    elif kernel == "ssm_scan":
        t, d = shape
        for bt in _clamp((32, 64, 128, 256), t, WARP):
            for bd in _clamp((32, 64, 128, 256), d, WARP):
                for depth in (1, 2, 4):
                    out.append(TileConfig(bt=bt, bd=bd, depth=depth))
    elif kernel == "csa_tree":
        h, n = shape
        for bh in _clamp((32, 64, 128, 256), h, WARP):
            for bn in _clamp((32, 64, 128, 256), n, WARP):
                out.append(TileConfig(bh=bh, bn=bn, depth=1))
    else:
        raise ValueError(f"unknown kernel {kernel!r}; have {KERNELS}")
    out = [c for c in out if feasible(kernel, c)]
    default = DEFAULT_TILES[kernel]
    if default in out:
        out.remove(default)
        out.insert(0, default)
    return out


_RULES = {
    "dcim_mac": f"its one compiled block {DEFAULT_TILES['dcim_mac'].bm} x "
                f"{DEFAULT_TILES['dcim_mac'].bn} x "
                f"{DEFAULT_TILES['dcim_mac'].bk}; depth in {MAC_DEPTHS}",
    "ssm_scan": f"shared memory of {SMEM_BUDGET_BYTES} B a block; bd a "
                f"multiple of {WARP} up to {MAX_THREADS}; depth in "
                f"{SSM_DEPTHS}",
    "csa_tree": f"bh 1..{CSA_REG_ROWS} rows in registers; bn a multiple of "
                f"{WARP} up to {CSA_THREADS}",
}


def resolve_tile(kernel: str, tile_config: "TileConfig | None") -> TileConfig:
    """Fill unset fields of an explicit config from the kernel default and
    check it against Hopper (:func:`feasible`); raises ValueError if the
    kernel cannot launch with it."""
    default = DEFAULT_TILES[kernel]
    if tile_config is None:
        return default
    if not isinstance(tile_config, TileConfig):
        raise TypeError(f"tile_config must be None, a TileConfig or "
                        f"\"auto\", got {tile_config!r}")
    merged = TileConfig(**{
        k: (v if v is not None else getattr(default, k))
        for k, v in dataclasses.asdict(tile_config).items()})
    if not feasible(kernel, merged):
        raise ValueError(
            f"{kernel} cannot launch with {merged.as_dict()} on Hopper "
            f"({_RULES[kernel]}); e.g. {DEFAULT_TILES[kernel].as_dict()}")
    return merged
