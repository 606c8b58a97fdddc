"""The port's first slice as a whole against the JAX package's batched path.

The JAX package's batched engine does not import in this process under the
installed jax (``from jax.experimental import enable_x64`` raises), so it
runs in a **subprocess** that first restores that name with
``jax.experimental.enable_x64 = lambda: jax.enable_x64(True)``.  The shim
lives only in that subprocess; this process and the reference suite never
see it.  The subprocess writes its results to a scratch directory, and the
tests hold the port (``device="cpu"``) to them:

* full-lattice ``evaluate`` arrays (the ``precision`` and ``approx_cell``
  axes on, 155,520 points per spec): **bitwise equal**;
* ``mso_search_many`` on the four scenario specs: every explored and
  frontier MacroPPA **exactly** equal, audit trail included;
* ``design_space_sweep_many(...).frontier_indices()``: the same indices in
  the same order;
* the scenario specs themselves and ``frontier_union``'s pool.

A last test runs the slice end to end the way ``chip_smoke.py`` does, at a
small size: a search picks a macro, and the qwen3-4b smoke config's GEMMs
run through ``dcim_matmul`` and match the Pallas kernel in interpret mode.
"""

import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.dcim_mac import dcim_matmul_int_pallas, dcim_matmul_pallas

import repro_torch.core as C
from repro_torch.configs import smoke_config
from repro_torch.convert import mac_operands_from_numpy
from repro_torch.core import subcircuits as sc
from repro_torch.kernels.dcim_mac import dcim_matmul, dcim_matmul_int

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
FULL = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
FULL_LATTICE_SPECS = ("pareto", "language", "wearable")


def canon(x):
    """Nested dicts as key-sorted item tuples: the JAX path's pytree
    round-trip returns dicts in sorted key order and the port keeps
    insertion order; the values are what is compared."""
    if isinstance(x, dict):
        return tuple((k, canon(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    return x


def result_text(r) -> str:
    """A SearchResult as text, the same in both processes: ``repr`` of a
    float round-trips, so equal text is equal bits."""
    return repr(canon((r.n_evaluated,
                       [dataclasses.asdict(p) for p in r.explored],
                       [dataclasses.asdict(p) for p in r.frontier])))


REFERENCE_SCRIPT = r"""
import dataclasses, json, pathlib, sys
import numpy as np
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.core import calibrated_tech_for_reference, pareto_experiment_spec
from repro.core import subcircuits as sc
from repro.core.axes import LatticeConfig
from repro.core.batched import DesignLattice, SpecTables, evaluate
from repro.core.multispec import (design_space_sweep_many, frontier_union,
                                  mso_search_many, scenario_specs)

""" + inspect.getsource(canon) + inspect.getsource(result_text) + r"""
out = pathlib.Path(sys.argv[1])
tech = calibrated_tech_for_reference()
scen = scenario_specs()
specs = {"pareto": pareto_experiment_spec(), **scen}

full = LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)
arrays = {}
for name in sys.argv[2].split(","):
    spec = specs[name]
    ppa = evaluate(DesignLattice.enumerate(spec, config=full),
                   SpecTables(spec, tech, config=full))
    for k in ("mac", "sa", "ofu", "crit", "fmax", "meets", "area",
              "latency", "tops_1b", "tops_mm2"):
        arrays[f"{name}/{k}"] = np.asarray(getattr(ppa, k))
    for group in ("breakdown", "e_cycle", "tops_w"):
        for k, v in getattr(ppa, group).items():
            arrays[f"{name}/{group}.{k}"] = np.asarray(v)
np.savez(out / "arrays.npz", **arrays)

results = mso_search_many(list(scen.values()), tech=tech)
sweeps = design_space_sweep_many(list(scen.values()), tech)
pool, labels = frontier_union(results, names=list(scen))
(out / "reference.json").write_text(json.dumps({
    "specs": {k: repr(dataclasses.asdict(v)) for k, v in scen.items()},
    "results": [result_text(r) for r in results],
    "fronts": [s.frontier_indices() for s in sweeps],
    "union": labels,
}))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Run the JAX package's batched path once in a subprocess."""
    out = tmp_path_factory.mktemp("jax_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(out),
         ",".join(FULL_LATTICE_SPECS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return arrays, json.loads((out / "reference.json").read_text())


@pytest.fixture(scope="module")
def tech():
    return C.calibrated_tech_for_reference()


def port_arrays(ppa) -> dict:
    out = {k: getattr(ppa, k) for k in ("mac", "sa", "ofu", "crit", "fmax",
                                        "meets", "area", "latency",
                                        "tops_1b", "tops_mm2")}
    for group in ("breakdown", "e_cycle", "tops_w"):
        for k, v in getattr(ppa, group).items():
            out[f"{group}.{k}"] = v
    return out


def bits(a: np.ndarray) -> np.ndarray:
    """Floats as their bit patterns, so NaN == NaN and -0.0 != 0.0."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint64) if a.dtype == np.float64 else a


SPECS = {"pareto": C.pareto_experiment_spec(), **C.scenario_specs()}


class TestAgainstJaxBatchedPath:
    @pytest.mark.parametrize("name", FULL_LATTICE_SPECS)
    def test_full_lattice_evaluate_arrays_equal(self, reference, tech, name):
        arrays, _ = reference
        spec = SPECS[name]
        lattice = C.DesignLattice.enumerate(spec, config=FULL)
        assert len(lattice) == 155_520
        ppa = C.evaluate(lattice, C.SpecTables(spec, tech, config=FULL),
                         device=CPU)
        got = port_arrays(ppa)
        want = {k.split("/", 1)[1]: v for k, v in arrays.items()
                if k.startswith(name + "/")}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            g = np.asarray(got[k])
            assert g.dtype == v.dtype, k
            np.testing.assert_array_equal(bits(g), bits(v), err_msg=k)

    def test_scenario_specs_equal(self, reference):
        _, ref = reference
        assert {k: repr(dataclasses.asdict(v))
                for k, v in C.scenario_specs().items()} == ref["specs"]

    def test_mso_search_many_equal(self, reference, tech):
        _, ref = reference
        results = C.mso_search_many(list(C.scenario_specs().values()),
                                    tech=tech, device=CPU)
        assert [result_text(r) for r in results] == ref["results"]

    def test_sweep_frontier_indices_equal(self, reference, tech):
        _, ref = reference
        sweeps = C.design_space_sweep_many(list(C.scenario_specs().values()),
                                           tech, device=CPU)
        assert [s.frontier_indices() for s in sweeps] == ref["fronts"]

    def test_frontier_union_equal(self, reference, tech):
        _, ref = reference
        scen = C.scenario_specs()
        results = C.mso_search_many(list(scen.values()), tech=tech,
                                    device=CPU)
        _, labels = C.frontier_union(results, names=list(scen))
        assert labels == ref["union"]


class TestSliceEndToEnd:
    def test_search_then_mac_at_smoke_size(self, tech):
        """A search picks a macro; the model's GEMMs run through the MAC
        wrappers at the macro's INT precision and match the Pallas kernels
        in interpret mode (int32 exact, f32 within rtol 1e-6)."""
        language = C.mso_search_many([C.scenario_specs()["language"]],
                                     tech=tech, device=CPU)[0]
        chosen = max(language.frontier,
                     key=lambda p: p.tops_per_w_1b["int_lo"])
        bits_ = max(chosen.design.ofu_precisions
                    or chosen.design.spec.int_precisions)
        lo, hi = -(1 << (bits_ - 1)), (1 << (bits_ - 1)) - 1
        rng = np.random.default_rng(17)
        gemms = C.gemm_inventory(smoke_config("qwen3-4b"), seq=16)
        assert [g.name for g in gemms] == ["wq", "wk", "wv", "wo", "mlp_up",
                                           "mlp_down"]
        for g in gemms:
            a = rng.integers(lo, hi + 1, (g.m, g.k), dtype=np.int8)
            w = rng.integers(lo, hi + 1, (g.k, g.n), dtype=np.int8)
            asc = rng.uniform(0.01, 2.0, g.m).astype(np.float32)
            wsc = rng.uniform(0.01, 2.0, g.n).astype(np.float32)
            ta, tw, tas, tws = mac_operands_from_numpy(a, w, asc, wsc,
                                                       device=CPU)
            np.testing.assert_array_equal(
                dcim_matmul_int(ta, tw).numpy(),
                np.asarray(dcim_matmul_int_pallas(jnp.asarray(a),
                                                  jnp.asarray(w),
                                                  interpret=True)))
            got = dcim_matmul(ta, tw, tas, tws, out_dtype=torch.float32)
            want = dcim_matmul_pallas(jnp.asarray(a), jnp.asarray(w),
                                      jnp.asarray(asc), jnp.asarray(wsc),
                                      interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
