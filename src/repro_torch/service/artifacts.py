"""Lossless JSON encoding of synthesis results for the on-disk cache stores.

The on-disk tiers — the :class:`repro_torch.service.cache.FrontierCache` local
store and the :class:`repro_torch.service.registry.ArtifactRegistry` shared store —
persist one :class:`repro_torch.core.searcher.SearchResult` per artifact.  The
encoding is bit-exact: every float field is written through Python's
shortest-round-trip float repr (IEEE-754 doubles survive a dump/load cycle
unchanged, including the ``inf`` TOPS/W of leakage-free corners), enums go
through their value strings, and tuples/dicts keep their order — so a
frontier loaded from disk satisfies the same bit-identity contract as an
in-memory hit (pinned by ``tests/test_service.py``).

Besides the codec this module owns the artifact *file discipline* both tiers
share: :func:`atomic_write_json` (unique temp name + fsync + atomic rename,
safe for concurrent writers of the same key on shared storage),
:func:`load_artifact` (read-and-validate, raising
:class:`CacheArtifactError` on any defect), and :func:`quarantine_artifact`
(rename a rejected artifact to ``<key>.corrupt`` at rejection time, so a
poisoned file can never warm-start another process).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from ..core.csa import CSADesign, CSAReport
from ..core.macro import MacroDesign, MacroPPA, MacroSpec, PathReport
from ..core.searcher import SearchResult
from ..core.subcircuits import ApproxCellSpec, MemCellKind, MultMuxKind
from .keys import canonical_spec

#: Schema tag of one persisted frontier artifact.
ARTIFACT_SCHEMA = "syndcim-frontier-artifact/v1"


class CacheArtifactError(ValueError):
    """An on-disk artifact failed validation (bad JSON, wrong schema, key
    mismatch, or a payload the decoder rejects)."""


def atomic_write_json(path, payload: dict) -> Path:
    """Write ``payload`` as JSON at ``path`` atomically, safely for
    concurrent writers of the same path on shared storage.

    The temp name is unique per writer (pid + random token, same directory,
    so the final ``os.replace`` stays within one filesystem): two processes
    racing on one key each complete their own temp file and the rename is
    atomic, so readers see either a complete old artifact or a complete new
    one — never a partial write, never another writer's clobbered temp.  The
    file is fsynced before the rename so a crash cannot leave a renamed but
    empty artifact behind."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}."
                         f"{os.urandom(6).hex()}.tmp")
    data = json.dumps(payload)
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def artifact_payload(key: str, result: SearchResult) -> dict:
    """The persisted form of one frontier artifact."""
    return {"schema": ARTIFACT_SCHEMA, "key": key,
            "result": result_to_payload(result)}


def load_artifact(path) -> tuple[str, SearchResult]:
    """Read and validate one artifact; returns ``(key, result)``.
    Raises :class:`CacheArtifactError` on any defect."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError) as e:
        raise CacheArtifactError(f"{path}: unreadable artifact: {e}")
    if not isinstance(data, dict) or data.get("schema") != ARTIFACT_SCHEMA:
        raise CacheArtifactError(
            f"{path}: not a frontier artifact (schema="
            f"{data.get('schema') if isinstance(data, dict) else None!r}, "
            f"expected {ARTIFACT_SCHEMA!r})")
    key = data.get("key")
    if not isinstance(key, str) or not key:
        raise CacheArtifactError(f"{path}: missing content key")
    try:
        result = result_from_payload(data["result"])
    except (KeyError, TypeError, ValueError) as e:
        raise CacheArtifactError(f"{path}: undecodable payload: {e}")
    return key, result


def quarantine_artifact(path) -> Path | None:
    """Move a rejected artifact out of the serving path (``<key>.json`` →
    ``<key>.corrupt``), so it can never be re-read as a cache entry and the
    next put has a clean slot.  Racing quarantiners are benign: whoever
    renames first wins, the loser's rename fails on the missing source and
    is ignored.  Returns the quarantine path, or None if the artifact was
    already gone."""
    path = Path(path)
    dest = path.with_suffix(".corrupt")
    try:
        os.replace(path, dest)
    except OSError:
        return None
    return dest


def spec_from_payload(p: dict) -> MacroSpec:
    return MacroSpec(h=int(p["h"]), w=int(p["w"]), mcr=int(p["mcr"]),
                     int_precisions=tuple(int(b)
                                          for b in p["int_precisions"]),
                     fp_precisions=tuple(str(f) for f in p["fp_precisions"]),
                     f_mac_hz=float(p["f_mac_hz"]),
                     f_wupdate_hz=float(p["f_wupdate_hz"]),
                     vdd=float(p["vdd"]), w_power=float(p["w_power"]),
                     w_area=float(p["w_area"]),
                     w_throughput=float(p["w_throughput"]))


def _design_to_payload(d: MacroDesign) -> dict:
    return {
        "memcell": d.memcell.value,
        "multmux": d.multmux.value,
        "csa": {"rho": d.csa.rho, "reorder": d.csa.reorder,
                "retimed": d.csa.retimed, "split": d.csa.split},
        "ofu_pipe_stages": d.ofu_pipe_stages,
        "ofu_retimed_into_sa": d.ofu_retimed_into_sa,
        "fuse_tree_sa": d.fuse_tree_sa,
        "fuse_sa_ofu": d.fuse_sa_ofu,
        "audit": list(d.audit),
        # Optional-axis coordinates (absent for seed designs, so seed
        # artifacts keep their historical byte layout).
        **({"ofu_precisions": list(d.ofu_precisions)}
           if d.ofu_precisions is not None else {}),
        **({"align_fp": list(d.align_fp)}
           if d.align_fp is not None else {}),
        **({"approx_cell": {"name": d.approx_cell.name,
                            "k_delay": d.approx_cell.k_delay,
                            "k_energy": d.approx_cell.k_energy,
                            "k_area": d.approx_cell.k_area}}
           if d.approx_cell is not None else {}),
    }


def _design_from_payload(p: dict, spec: MacroSpec) -> MacroDesign:
    return MacroDesign(
        spec=spec, memcell=MemCellKind(p["memcell"]),
        multmux=MultMuxKind(p["multmux"]),
        csa=CSADesign(rho=float(p["csa"]["rho"]),
                      reorder=bool(p["csa"]["reorder"]),
                      retimed=bool(p["csa"]["retimed"]),
                      split=int(p["csa"]["split"])),
        ofu_pipe_stages=int(p["ofu_pipe_stages"]),
        ofu_retimed_into_sa=bool(p["ofu_retimed_into_sa"]),
        fuse_tree_sa=bool(p["fuse_tree_sa"]),
        fuse_sa_ofu=bool(p["fuse_sa_ofu"]),
        audit=tuple(p["audit"]),
        ofu_precisions=(tuple(int(b) for b in p["ofu_precisions"])
                        if "ofu_precisions" in p else None),
        align_fp=(tuple(str(f) for f in p["align_fp"])
                  if "align_fp" in p else None),
        approx_cell=(ApproxCellSpec(name=str(p["approx_cell"]["name"]),
                                    k_delay=float(p["approx_cell"]["k_delay"]),
                                    k_energy=float(
                                        p["approx_cell"]["k_energy"]),
                                    k_area=float(p["approx_cell"]["k_area"]))
                     if "approx_cell" in p else None))


_CSA_REPORT_FIELDS = ("crit_path_rel", "energy_rel", "area_um2", "n_fa",
                      "n_comp42", "n_ha", "n_reg_bits", "stages",
                      "latency_cycles", "acc_width", "rca_width")


def _ppa_to_payload(p: MacroPPA) -> dict:
    return {
        "design": _design_to_payload(p.design),
        "paths": {"mac_path_rel": p.paths.mac_path_rel,
                  "sa_path_rel": p.paths.sa_path_rel,
                  "ofu_path_rel": p.paths.ofu_path_rel,
                  "crit_rel": p.paths.crit_rel},
        "fmax_hz": p.fmax_hz,
        "area_um2": p.area_um2,
        "area_breakdown": dict(p.area_breakdown),
        "e_cycle_fj": dict(p.e_cycle_fj),
        "latency_cycles": int(p.latency_cycles),
        "tops_1b": p.tops_1b,
        "tops_per_w_1b": dict(p.tops_per_w_1b),
        "tops_per_mm2_1b": p.tops_per_mm2_1b,
        "meets_timing": bool(p.meets_timing),
        "csa_report": (None if p.csa_report is None else
                       {k: getattr(p.csa_report, k)
                        for k in _CSA_REPORT_FIELDS}),
    }


def _ppa_from_payload(p: dict, spec: MacroSpec) -> MacroPPA:
    csa_rep = p.get("csa_report")
    return MacroPPA(
        design=_design_from_payload(p["design"], spec),
        paths=PathReport(float(p["paths"]["mac_path_rel"]),
                         float(p["paths"]["sa_path_rel"]),
                         float(p["paths"]["ofu_path_rel"]),
                         float(p["paths"]["crit_rel"])),
        fmax_hz=float(p["fmax_hz"]), area_um2=float(p["area_um2"]),
        area_breakdown={k: float(v)
                        for k, v in p["area_breakdown"].items()},
        e_cycle_fj={k: float(v) for k, v in p["e_cycle_fj"].items()},
        latency_cycles=int(p["latency_cycles"]),
        tops_1b=float(p["tops_1b"]),
        tops_per_w_1b={k: float(v) for k, v in p["tops_per_w_1b"].items()},
        tops_per_mm2_1b=float(p["tops_per_mm2_1b"]),
        meets_timing=bool(p["meets_timing"]),
        csa_report=(None if csa_rep is None else
                    CSAReport(**{k: csa_rep[k]
                                 for k in _CSA_REPORT_FIELDS})))


def result_to_payload(r: SearchResult) -> dict:
    """Plain-data encoding of one SearchResult (JSON-serializable)."""
    return {
        "spec": canonical_spec(r.spec),
        "frontier": [_ppa_to_payload(p) for p in r.frontier],
        "explored": [_ppa_to_payload(p) for p in r.explored],
        "n_evaluated": int(r.n_evaluated),
    }


def result_from_payload(d: dict) -> SearchResult:
    """Inverse of :func:`result_to_payload`, bit-exact per field."""
    spec = spec_from_payload(d["spec"])
    return SearchResult(
        spec=spec,
        frontier=tuple(_ppa_from_payload(p, spec) for p in d["frontier"]),
        explored=tuple(_ppa_from_payload(p, spec) for p in d["explored"]),
        n_evaluated=int(d["n_evaluated"]))
