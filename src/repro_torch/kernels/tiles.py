"""Tile/pipeline configuration shared by the DCIM-path kernels.

A :class:`TileConfig` names every tunable of one kernel launch: the block
shape the grid is cut into and the pipeline ``depth``.  The port carries the
type and the per-kernel defaults so launch postures keep their meaning
across the two packages; which configs are feasible on Hopper (a shared
memory budget per block, warp/MMA alignment) is re-derived with the
kernel-support slice, and the hand-written kernels take no ``TileConfig``
until then.

Field semantics per kernel (unused fields stay None):

  dcim_mac   bm x bn output tile, bk K-chunk, depth-slot operand streaming
  ssm_scan   bt T-chunk, bd D-tile (lanes), depth-slot (a, b) streaming
  csa_tree   bh row tile (the tiled-H variant), bn lane tile
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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


#: Per-kernel default launch posture (the JAX package's TPU blocks).
DEFAULT_TILES: dict[str, TileConfig] = {
    "dcim_mac": TileConfig(bm=128, bn=128, bk=128, depth=2),
    "ssm_scan": TileConfig(bt=128, bd=128, depth=2),
    "csa_tree": TileConfig(bh=128, bn=256, depth=1),
}

KERNELS = tuple(DEFAULT_TILES)


def resolve_tile(kernel: str, tile_config: "TileConfig | None") -> TileConfig:
    """Fill unset fields of an explicit config from the kernel default."""
    default = DEFAULT_TILES[kernel]
    if tile_config is None:
        return default
    merged = {k: (v if v is not None else getattr(default, k))
              for k, v in dataclasses.asdict(tile_config).items()}
    return TileConfig(**merged)
