"""Copy-vs-compute profiling of the port's kernels (the counterpart of the
JAX package's ``repro/kernels/profile.py``).

Multi-buffered pipelines pay off only when streaming the operands of one
stage overlaps the arithmetic on another, and tuning a ring's depth makes
sense only once it is known which side bounds the kernel.  This harness
answers that per ``(kernel, shape, tile)`` by timing three skeletons of the
*same* kernel (the ``_mode`` argument of the kernel bindings, each a
compile-time mode of the CUDA source):

  copy     the streaming runs, the arithmetic is skipped; a data token
           keeps the loads alive -> streaming time;
  compute  the arithmetic runs on resident data, nothing streams
           -> arithmetic time;
  fused    the real kernel -> what ships.

Classification: a kernel is **bandwidth-bound** when the copy skeleton
dominates (``t_copy >= t_compute``), compute-bound otherwise.  The
``roofline_fraction`` is ``max(t_copy, t_compute) / t_fused``: how close
the fused kernel comes to hiding the cheaper side under the dearer one
(1.0 = perfect overlap).  :mod:`repro_torch.roofline.dcim` takes this
fraction to derate its analytic serving bound.

``csa_tree`` has no compute skeleton (its rows are loaded where the tree
reads them, as the TPU kernel's BlockSpec streaming cannot be turned off),
so its compute time is *derived* as ``max(fused - copy, 0)`` and flagged
``compute_measured=False``.

``device=None`` is the CUDA card (:mod:`repro_torch.device`): the
skeletons run as CUDA kernels and are timed with CUDA events, L2 flushed
(:func:`repro_torch.kernels.timing.times_ms`), the best of ``iters``.
``device="cpu"`` runs their plain versions and reads the host clock: the
plumbing is the same, the times say nothing of the card.  Neither falls
back to the other.  The artifact (``profiles_payload``) is byte-compatible
with the JAX package's: the same schema tag, keys and numbers' meaning,
with ``backend`` ``"cuda"`` or ``"cpu"``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from ..device import resolve_device
from .tiles import TileConfig, resolve_tile
from .timing import times_ms

#: Mode tags understood by the kernel bindings' ``_mode`` argument.
MODES = ("copy", "compute", "fused")

#: Schema tag of the persisted kernel-profile artifact
#: (``scripts/torch_profile_kernels.py --json`` output).
PROFILE_SCHEMA = "syndcim-kernel-profile/v1"

#: Seed of the profiled operands.
SEED = 1


@dataclass
class KernelProfile:
    """Timing split of one (kernel, shape, tile) point."""

    kernel: str
    shape: tuple[int, ...]
    tile: TileConfig
    t_copy_us: float
    t_compute_us: float
    t_fused_us: float
    bytes_moved: int          # analytic HBM traffic of one fused launch
    flops: int                # analytic arithmetic of one fused launch
    compute_measured: bool    # False when compute was derived (csa_tree)
    backend: str | None = None   # device type it ran on (not in as_dict)

    @property
    def bound(self) -> str:
        return "bandwidth" if self.t_copy_us >= self.t_compute_us else "compute"

    @property
    def roofline_fraction(self) -> float:
        """Pipeline efficiency: the slower skeleton over the fused time
        (1.0 = the cheap side is perfectly hidden)."""
        if self.t_fused_us <= 0.0:
            return 0.0
        return min(1.0, max(self.t_copy_us, self.t_compute_us)
                   / self.t_fused_us)

    def as_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "shape": list(self.shape),
            "tile": self.tile.as_dict(),
            "t_copy_us": self.t_copy_us,
            "t_compute_us": self.t_compute_us,
            "t_fused_us": self.t_fused_us,
            "bytes_moved": self.bytes_moved,
            "flops": self.flops,
            "bound": self.bound,
            "roofline_fraction": self.roofline_fraction,
            "compute_measured": self.compute_measured,
        }


def _traffic(kernel: str, shape: tuple[int, ...]) -> tuple[int, int]:
    """(bytes_moved, flops) of one fused launch, analytic, as the JAX
    package counts them (they are fields of the artifact's schema)."""
    if kernel == "dcim_mac":
        m, k, n = shape
        return m * k + k * n + 4 * m * n, 2 * m * k * n
    if kernel == "ssm_scan":
        t, d = shape
        # in: a, b; out: states (+ final).  The count is the TPU kernel's
        # doubling scan (~3 vector ops per level, log2(bt) ~ 7 levels, plus
        # the carry fix), kept for the schema; the card's kernel does one
        # multiply and one add per element (PERF.md bounds it by that).
        levels = 7
        return 4 * (3 * t * d + d), t * d * (3 * levels + 2)
    if kernel == "csa_tree":
        h, n = shape
        # ~5 bitwise ops per lane per reduced row (FA: 3 xor/and + or + shift)
        return 4 * (h * n + n), 5 * h * n
    raise ValueError(f"unknown kernel {kernel!r}")


def _runner(kernel: str, shape: tuple[int, ...], tc: TileConfig,
            device: torch.device):
    """mode -> zero-arg callable running one launch of that skeleton on
    ``device`` (its CUDA kernel on the card, its plain version on the
    CPU), on operands drawn from :data:`SEED`."""
    g = torch.Generator(device=device).manual_seed(SEED)
    cuda = device.type == "cuda"
    if kernel == "dcim_mac":
        from .dcim_mac import kernel as K, ref
        from .dcim_mac.plan import tma_describable
        m, k, n = shape
        a = torch.randint(-8, 8, (m, k), generator=g, device=device,
                          dtype=torch.int8)
        w = torch.randint(-8, 8, (k, n), generator=g, device=device,
                          dtype=torch.int8)
        # the three modes time the TMA kernel, as the JAX harness times the
        # pipelined kernel; it never switches to another kernel
        if not tma_describable(k, n, a.data_ptr(), w.data_ptr()):
            raise ValueError(
                f"dcim_mac {m}x{k}x{n}: the profiler times the TMA kernel, "
                f"which needs K and N multiples of 16")
        plain = {"fused": ref.dcim_matmul_int_ref,
                 "copy": ref.dcim_mac_copy_ref,
                 "compute": ref.dcim_mac_compute_ref}

        def run(mode: str):
            if cuda:
                return K.dcim_mac_int_cuda(a, w, depth=tc.depth, _mode=mode)
            return plain[mode](a, w)
    elif kernel == "ssm_scan":
        from .ssm_scan import kernel as K, ref
        t, d = shape
        a = 0.9 + 0.05 * torch.randn((t, d), generator=g, device=device)
        b = torch.randn((t, d), generator=g, device=device)
        h0 = torch.zeros((d,), device=device)
        chunks = ref.ssm_chunks(t, d)[0]
        plain = {"fused": lambda: ref.ssm_scan_chunked_ref(a, b, h0, chunks),
                 "copy": lambda: ref.ssm_scan_copy_ref(a, b, h0, tc.bt),
                 "compute": lambda: ref.ssm_scan_compute_ref(a, b, h0,
                                                             chunks, tc.bt)}

        def run(mode: str):
            if cuda:
                return K.ssm_scan_cuda(a, b, h0, bt=tc.bt, bd=tc.bd,
                                       depth=tc.depth, _mode=mode)
            return plain[mode]()
    elif kernel == "csa_tree":
        from .csa_tree import kernel as K, ref
        h, n = shape
        x = torch.randint(-1000, 1000, (h, n), generator=g, device=device,
                          dtype=torch.int32)
        plain = {"fused": ref.csa_tree_ref,
                 "copy": lambda x: ref.csa_tree_copy_ref(x, tc.bh)}

        def run(mode: str):
            if cuda:
                return K.csa_tree_tiled_cuda(x, bh=tc.bh, bn=tc.bn,
                                             _mode=mode)
            return plain[mode](x)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return run


def _time_us(fn, iters: int, device: torch.device) -> float:
    return min(times_ms(fn, iters, device)) * 1e3


def profile_kernel(kernel: str, shape: tuple[int, ...], *,
                   tile_config: TileConfig | None = None, iters: int = 3,
                   device=None) -> KernelProfile:
    """Time the copy / compute / fused skeletons of one kernel launch on
    ``device`` (None: the CUDA card)."""
    shape = tuple(int(d) for d in shape)
    dev = resolve_device(device)
    tc = resolve_tile(kernel, tile_config)
    run = _runner(kernel, shape, tc, dev)

    t_fused = _time_us(lambda: run("fused"), iters, dev)
    t_copy = _time_us(lambda: run("copy"), iters, dev)
    if kernel == "csa_tree":
        t_compute, measured = max(t_fused - t_copy, 0.0), False
    else:
        t_compute, measured = _time_us(lambda: run("compute"), iters,
                                       dev), True

    nbytes, flops = _traffic(kernel, shape)
    return KernelProfile(kernel=kernel, shape=shape, tile=tc,
                         t_copy_us=t_copy, t_compute_us=t_compute,
                         t_fused_us=t_fused, bytes_moved=nbytes,
                         flops=flops, compute_measured=measured,
                         backend=dev.type)


def fraction_from_profiles(profiles) -> float:
    """Aggregate roofline fraction for the serving-bound derate: the
    geometric mean of per-kernel fractions (each in (0, 1]) — duck-typed so
    :mod:`repro_torch.roofline.dcim` need not import this module."""
    fracs = [max(1e-6, float(p.roofline_fraction)) for p in profiles]
    if not fracs:
        return 1.0
    return float(math.exp(sum(math.log(f) for f in fracs) / len(fracs)))


def profiles_payload(profiles) -> dict:
    """The machine-readable artifact of one profiling run: schema tag, the
    device type the profiles ran on (``backend``: ``"cuda"`` or ``"cpu"``;
    None for none), the per-point timing splits, and the pre-aggregated
    serving derate (so the consumer need not recompute the geomean)."""
    profiles = list(profiles)
    backends = {p.backend for p in profiles}
    if len(backends) > 1:
        raise ValueError(f"profiles from several backends: {backends}")
    return {
        "schema": PROFILE_SCHEMA,
        "backend": backends.pop() if backends else None,
        "fraction": fraction_from_profiles(profiles),
        "profiles": [p.as_dict() for p in profiles],
    }


def load_profile_artifact(path) -> dict:
    """Read a kernel-profile artifact; a missing file is an error (the
    caller was pointed at a measurement that must exist).  A legacy bare
    list of profile dicts (pre-schema ``--json`` output) is upgraded in
    memory."""
    p = Path(path)
    data = json.loads(p.read_text())
    if isinstance(data, list):                      # legacy bare list
        fracs = [max(1e-6, float(d["roofline_fraction"])) for d in data]
        frac = (float(math.exp(sum(math.log(f) for f in fracs)
                               / len(fracs))) if fracs else 1.0)
        return {"schema": PROFILE_SCHEMA, "backend": None,
                "fraction": frac, "profiles": data}
    if not isinstance(data, dict) or data.get("schema") != PROFILE_SCHEMA:
        raise ValueError(f"{p}: not a kernel profile "
                         f"(schema={data.get('schema') if isinstance(data, dict) else type(data).__name__!r}, "
                         f"expected {PROFILE_SCHEMA!r})")
    return data


def fraction_from_profile_artifact(path) -> float:
    """The serving-roofline derate recorded in (or derivable from) a
    profile artifact, clamped to (0, 1]."""
    data = load_profile_artifact(path)
    frac = float(data.get("fraction", 1.0))
    if not (0.0 < frac <= 1.0):
        raise ValueError(f"{path}: fraction must be in (0, 1], got {frac}")
    return frac
