"""Tile autotuning for the port's three CUDA kernels via the DSE machinery.

The synthesis side picks subcircuits by sweeping a candidate lattice,
scoring each candidate on several objectives and keeping the Pareto
frontier; the kernel layer reuses that idiom one level down, as the JAX
package's ``repro.kernels.autotune`` does.  For one ``(kernel, shape)`` the
tuner

  1. enumerates the Hopper-feasible (block-shape, depth) lattice from
     :func:`repro_torch.kernels.tiles.tile_space`;
  2. runs every candidate through the kernel's public entry point against
     the plain version (a candidate past ``_MAX_ERR`` is disqualified,
     never timed);
  3. times each survivor with CUDA events after a warm-up and scores it on
     ``(time_us, smem_bytes)``;
  4. extracts the frontier with :func:`repro_torch.core.pareto.
     pareto_indices` and picks its fastest member.

Winners persist through a registry as JSON payloads (schema
:data:`TILE_SCHEMA`, the JAX package's), content-addressed by ``(kernel,
shape-class, backend digest)``.  The registry is duck-typed: anything with
``publish_payload(key, payload, schema=...)`` and ``fetch_payload(key,
schema=...)``.  The backend digest names the card (name, compute
capability) and the torch and CUDA versions, or just "cpu": with
``device="cpu"`` every candidate runs the plain version, and nothing tuned
there is taken for the card.  :func:`lookup` is the read path the entry
points' ``tile_config="auto"`` calls: process memo, then registry, then the
static default.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.pareto import pareto_indices
from ..device import resolve_device
from .tiles import (DEFAULT_TILES, TileConfig, resolve_tile, shape_class,
                    smem_bytes, tile_space)

#: Schema tag of one persisted tile-winner payload.
TILE_SCHEMA = "syndcim-kernel-tile/v1"

#: Exactness contract per kernel: the integer kernels must equal the plain
#: version bit for bit; the float scan gets the JAX package's tolerance.
_MAX_ERR = {"dcim_mac": 0.0, "csa_tree": 0.0, "ssm_scan": 1e-3}


def _digest(obj) -> str:
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def backend_digest(device=None) -> str:
    """Content digest of the execution substrate a tuning is valid for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _digest({"device": dev.type, "torch": torch.__version__})
    return _digest({"device": torch.cuda.get_device_name(dev),
                    "capability": list(torch.cuda.get_device_capability(dev)),
                    "torch": torch.__version__, "cuda": torch.version.cuda})


def tile_key(kernel: str, shape: tuple[int, ...], device=None) -> str:
    """Registry address of one tuning: (kernel, shape-class, backend)."""
    return _digest({"kind": "kernel-tile", "kernel": kernel,
                    "shape_class": shape_class(kernel, tuple(shape)),
                    "backend": backend_digest(device)})


@dataclass
class CandidateScore:
    """One evaluated lattice point."""

    config: TileConfig
    time_us: float
    smem_bytes: int
    max_err: float
    ok: bool


@dataclass
class TuneResult:
    """Outcome of one autotune sweep."""

    kernel: str
    shape: tuple[int, ...]
    shape_class: str
    backend: str
    winner: TileConfig
    time_us: float
    picked_nondefault: bool
    candidates: list[CandidateScore] = field(default_factory=list)
    frontier: list[int] = field(default_factory=list)
    key: str = ""

    def payload(self) -> dict:
        """The registry artifact body (JSON-safe)."""
        return {
            "kernel": self.kernel,
            "shape_class": self.shape_class,
            "backend": self.backend,
            "tile": self.winner.as_dict(),
            "time_us": self.time_us,
            "picked_nondefault": self.picked_nondefault,
            "n_candidates": len(self.candidates),
            "n_frontier": len(self.frontier),
        }


def _make_case(kernel: str, shape: tuple[int, ...], device: torch.device):
    """Deterministic inputs on ``device``, the plain version's output as
    float64 numpy, and a per-config runner through the entry point."""
    rng = np.random.default_rng(0)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    if kernel == "dcim_mac":
        from .dcim_mac import dcim_matmul_int, ref
        m, k, n = shape
        a = put(rng.integers(-8, 8, (m, k)), torch.int8)
        w = put(rng.integers(-8, 8, (k, n)), torch.int8)
        want = ref.dcim_matmul_int_ref(a, w)

        def run(cfg: TileConfig):
            return dcim_matmul_int(a, w, tile_config=cfg)
    elif kernel == "ssm_scan":
        from .ssm_scan import ssm_scan, ssm_scan_ref
        t, d = shape
        a = put(0.9 + 0.05 * rng.standard_normal((t, d)), torch.float32)
        b = put(rng.standard_normal((t, d)), torch.float32)
        h0 = put(rng.standard_normal((d,)), torch.float32)
        want = ssm_scan_ref(a, b, h0)[0]

        def run(cfg: TileConfig):
            return ssm_scan(a, b, h0, tile_config=cfg)[0]
    elif kernel == "csa_tree":
        from .csa_tree import csa_tree_ref, csa_tree_sum
        h, n = shape
        x = put(rng.integers(-1000, 1000, (h, n)), torch.int32)
        want = csa_tree_ref(x)

        def run(cfg: TileConfig):
            return csa_tree_sum(x, tile_config=cfg)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return run, want.double().cpu().numpy()


def _time_us(fn, iters: int, device: torch.device) -> float:
    """Best of ``iters`` calls after a warm-up: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e6)
        return best
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize(device)
    return min(s.elapsed_time(e) for s, e in times) * 1e3


def autotune(kernel: str, shape: tuple[int, ...], *, iters: int = 3,
             device=None, registry=None, memoize: bool = True) -> TuneResult:
    """Sweep the tile lattice for ``(kernel, shape)`` on ``device`` (None:
    the CUDA card) and pick a winner; publish it to ``registry`` under
    :func:`tile_key` when one is given, and memoize it for ``"auto"``."""
    shape = tuple(int(d) for d in shape)
    dev = resolve_device(device)
    run, want = _make_case(kernel, shape, dev)
    tol = _MAX_ERR[kernel]

    scores: list[CandidateScore] = []
    for cfg in tile_space(kernel, shape):
        out = run(cfg).double().cpu().numpy()
        err = float(np.max(np.abs(out - want))) if out.size else 0.0
        ok = err <= tol
        t_us = _time_us(lambda: run(cfg), iters, dev) if ok else float("inf")
        scores.append(CandidateScore(cfg, t_us, smem_bytes(kernel, cfg),
                                     err, ok))
    live = [i for i, s in enumerate(scores) if s.ok]
    if not live:
        raise RuntimeError(
            f"autotune({kernel}, {shape}): every candidate failed the "
            f"exactness check — kernel bug, not a tuning problem")

    objs = [(scores[i].time_us, float(scores[i].smem_bytes)) for i in live]
    frontier = [live[j] for j in pareto_indices(objs)]
    win_idx = min(frontier, key=lambda i: scores[i].time_us)
    winner = scores[win_idx].config

    result = TuneResult(
        kernel=kernel, shape=shape,
        shape_class=shape_class(kernel, shape),
        backend=backend_digest(dev),
        winner=winner, time_us=scores[win_idx].time_us,
        picked_nondefault=(winner != DEFAULT_TILES[kernel]),
        candidates=scores, frontier=frontier,
        key=tile_key(kernel, shape, dev))
    if registry is not None:
        registry.publish_payload(result.key, result.payload(),
                                 schema=TILE_SCHEMA)
    if memoize:
        _MEMO[result.key] = winner
    return result


# -- the read path ("auto" tile_config) --------------------------------------

#: Process-wide memo: tile_key -> winning TileConfig.  Misses fall through
#: to the configured registry, then to the static default.
_MEMO: dict[str, TileConfig] = {}

_REGISTRY = None


def set_registry(registry) -> None:
    """Install the process-default registry the ``"auto"`` path consults.
    None disables it."""
    global _REGISTRY
    _REGISTRY = registry


def clear_memo() -> None:
    _MEMO.clear()


def lookup_with_source(kernel: str, shape: tuple[int, ...], registry=None,
                       device=None) -> tuple[TileConfig, str]:
    """:func:`lookup` plus where the config came from: ``"memo"`` (process
    memo), ``"registry"`` (shared payload, memoized on the way out), or
    ``"default"`` (the static per-kernel posture) — the attribution the
    kernel-dispatch spans and counters record."""
    shape = tuple(int(d) for d in shape)
    key = tile_key(kernel, shape, device)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit, "memo"
    reg = registry if registry is not None else _REGISTRY
    if reg is not None:
        payload = reg.fetch_payload(key, schema=TILE_SCHEMA)
        if payload is not None and isinstance(payload.get("tile"), dict):
            cfg = TileConfig.from_dict(payload["tile"])
            _MEMO[key] = cfg
            return cfg, "registry"
    return DEFAULT_TILES[kernel], "default"


def lookup(kernel: str, shape: tuple[int, ...], registry=None,
           device=None) -> TileConfig:
    """The tile config ``tile_config="auto"`` resolves to: process memo →
    registry payload → per-kernel default.  Never raises on a cold cache."""
    return lookup_with_source(kernel, shape, registry=registry,
                              device=device)[0]


def select_tile(kernel: str, shape: tuple[int, ...], tile_config,
                device) -> tuple[TileConfig, str]:
    """The tile an entry point launches with, and its attribution:
    the :func:`lookup_with_source` chain for ``"auto"``, ``"explicit"`` for
    a caller's :class:`TileConfig` (checked against Hopper by
    :func:`resolve_tile`), ``"default"`` for None."""
    if isinstance(tile_config, str):
        if tile_config != "auto":
            raise ValueError(f"tile_config must be None, a TileConfig or "
                             f"\"auto\", got {tile_config!r}")
        return lookup_with_source(kernel, shape, device=device)
    return (resolve_tile(kernel, tile_config),
            "default" if tile_config is None else "explicit")
