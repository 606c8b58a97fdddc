"""The benchmark's manifest and the files it names, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells (``workloads``) and the metrics.  Everything that belongs to one of
them sits in a file of its own under ``perfbench/``:

* ``configs/<config>.json``: a configuration as it is run (the manifest's
  ``file``);
* ``traffic/<mix>.json``: a traffic mix, whose ``kind`` names the
  module that generates and serves it, ``kinds/<kind>.py``;
* ``checks/<cell>.json``: the limits of the comparison that decides
  ``correct`` in that cell;
* ``metrics/<metric>.py``: the reader of one metric (``read(rec)``);
* ``reference/<family>.py`` and ``counts/<family>.py``: a model family's
  plain float32 reference and the FLOPs and bytes its step needs.

Adding a configuration, a mix, a cell or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    check: dict           # the limits of the comparison
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest, its files read."""
    manifest = load_manifest(root) if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read_json(root / configs[w["config"]]["file"]),
        traffic=_read_json(root / "perfbench" / "traffic"
                           / f"{w['traffic']}.json"),
        check=_read_json(root / "perfbench" / "checks" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)])


def load_reader(metric: str, root: Path = ROOT):
    """The ``read(rec)`` function of ``metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_family(kind: str, family: str):
    """``perfbench/<kind>/<family>.py`` as a module (``kind``:
    ``reference`` or ``counts``)."""
    return importlib.import_module(f"perfbench.{kind}.{family}")


def load_kind(traffic: dict):
    """The module of a traffic file's ``kind``: ``kinds/<kind>.py``, whose
    ``Pool`` generates and serves that traffic."""
    return importlib.import_module(f"perfbench.kinds.{traffic['kind']}")


def load_json(rel: str, root: Path = ROOT) -> dict:
    """A data file of the benchmark by its path under ``perfbench/``."""
    return _read_json(root / "perfbench" / rel)
