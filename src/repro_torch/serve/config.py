"""Serving-launcher DCIM configuration: one typed dataclass for the flag
cluster of the JAX package's serving launcher.

``repro.launch.serve`` accumulated parallel ``--dcim-*`` flags
(``--dcim-select``, ``--dcim-pref``, ``--dcim-profile``, ``--dcim-cache``,
``--dcim-macros``); deployment tooling had no way to version that posture
as an artifact.  :class:`ServeConfig` consolidates them, and
``--dcim-config PATH`` loads one from JSON — **explicit CLI flags override
the file**, so an ops-managed config can be locally overridden per launch:

    {"schema": "syndcim-serve-config/v1",
     "select": true,
     "pref": [0.2, 0.6, 0.2],
     "profile": "deploy/profile.json",
     "cache": "deploy/frontiers",
     "registry": "/mnt/shared/syndcim-registry",
     "macros": 256,
     "trace": "deploy/trace.json",
     "trace_sample": 1.0,
     "kernel_profile": "deploy/kernel_profile.json"}

Unknown keys are rejected (a typo'd posture must fail loudly, not silently
serve defaults).

``trace`` enables :mod:`repro_torch.obs` request tracing for the launch and
names the Chrome-trace output path (load it at ``ui.perfetto.dev``);
``trace_sample`` is the head-based trace sampling rate in (0, 1];
``kernel_profile`` points at a ``scripts/torch_profile_kernels.py --json``
artifact whose measured pipeline efficiency derates the serving roofline.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Optional

#: Schema tag of the persisted serve-config artifact.
SERVE_CONFIG_SCHEMA = "syndcim-serve-config/v1"


@dataclass(frozen=True)
class ServeConfig:
    """The DCIM serving posture of one launch.

    ``select`` turns macro selection on; ``pref`` is the (wallclock,
    energy, area) preference vector; ``profile`` / ``cache`` are the
    preference-profile and frontier-cache artifact paths; ``registry`` is
    the fleet-shared artifact-registry root (shared storage — any spec
    synthesized by any host is a cache hit on every host); ``macros`` the
    macro-array size assumed by co-design; ``trace`` the Chrome-trace
    output path (None = tracing off) with ``trace_sample`` the head
    sampling rate in (0, 1]; ``kernel_profile`` a measured kernel-profile
    artifact derating the serving roofline."""

    select: bool = False
    pref: Optional[tuple[float, float, float]] = None
    profile: Optional[str] = None
    cache: Optional[str] = None
    registry: Optional[str] = None
    macros: int = 256
    trace: Optional[str] = None
    trace_sample: float = 1.0
    kernel_profile: Optional[str] = None

    def __post_init__(self):
        if self.pref is not None:
            p = tuple(float(x) for x in self.pref)
            if len(p) != 3:
                raise ValueError(f"pref needs 3 weights "
                                 f"(wallclock, energy, area), got {p}")
            object.__setattr__(self, "pref", p)
        if self.macros < 1:
            raise ValueError("macros must be >= 1")
        s = float(self.trace_sample)
        if not (0.0 < s <= 1.0):
            raise ValueError(f"trace_sample must be in (0, 1], got {s}")
        object.__setattr__(self, "trace_sample", s)


def parse_pref(text: str) -> tuple[float, float, float]:
    """Parse the ``--dcim-pref W,E,A`` flag value."""
    parts = tuple(float(x) for x in text.split(","))
    if len(parts) != 3:
        raise ValueError(f"--dcim-pref needs 3 comma-separated weights "
                         f"wallclock,energy,area, got {text!r}")
    return parts


def load_serve_config(path) -> ServeConfig:
    """Read a serve-config artifact; a missing file is an error (a config
    the launch was pointed at must exist — unlike preference profiles,
    there is no seed-on-first-run story here)."""
    p = Path(path)
    data = json.loads(p.read_text())
    if not isinstance(data, dict):
        raise ValueError(f"{p}: serve config must be a JSON object")
    if data.get("schema") != SERVE_CONFIG_SCHEMA:
        raise ValueError(f"{p}: not a serve config "
                         f"(schema={data.get('schema')!r}, "
                         f"expected {SERVE_CONFIG_SCHEMA!r})")
    known = {f.name for f in fields(ServeConfig)}
    body = {k: v for k, v in data.items() if k != "schema"}
    unknown = sorted(set(body) - known)
    if unknown:
        raise ValueError(f"{p}: unknown serve-config keys {unknown}; "
                         f"known: {sorted(known)}")
    if body.get("pref") is not None:
        body["pref"] = tuple(body["pref"])
    return ServeConfig(**body)


def save_serve_config(path, config: ServeConfig) -> None:
    """Write a serve-config artifact (deterministic layout)."""
    payload = {
        "schema": SERVE_CONFIG_SCHEMA,
        "select": config.select,
        "pref": None if config.pref is None else list(config.pref),
        "profile": config.profile,
        "cache": config.cache,
        "registry": config.registry,
        "macros": config.macros,
        "trace": config.trace,
        "trace_sample": config.trace_sample,
        "kernel_profile": config.kernel_profile,
    }
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")


def serve_config_from_args(args) -> ServeConfig:
    """Resolve the launch posture: start from ``--dcim-config`` (or
    defaults), then apply every explicitly-passed CLI flag on top —
    existing flags keep working and override the file.  ``args`` is the
    launcher's parsed namespace (``dcim_select`` et al.; flag defaults are
    ``False``/``None`` so "explicitly passed" is detectable)."""
    cfg = (load_serve_config(args.dcim_config)
           if getattr(args, "dcim_config", None) else ServeConfig())
    overrides: dict = {}
    if getattr(args, "dcim_select", False):
        overrides["select"] = True
    if getattr(args, "dcim_pref", None) is not None:
        overrides["pref"] = parse_pref(args.dcim_pref)
    if getattr(args, "dcim_profile", None) is not None:
        overrides["profile"] = args.dcim_profile
    if getattr(args, "dcim_cache", None) is not None:
        overrides["cache"] = args.dcim_cache
    if getattr(args, "dcim_registry", None) is not None:
        overrides["registry"] = args.dcim_registry
    if getattr(args, "dcim_macros", None) is not None:
        overrides["macros"] = int(args.dcim_macros)
    if getattr(args, "dcim_trace", None) is not None:
        overrides["trace"] = args.dcim_trace
    if getattr(args, "dcim_trace_sample", None) is not None:
        overrides["trace_sample"] = float(args.dcim_trace_sample)
    if getattr(args, "dcim_kernel_profile", None) is not None:
        overrides["kernel_profile"] = args.dcim_kernel_profile
    return replace(cfg, **overrides) if overrides else cfg
