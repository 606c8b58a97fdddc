"""The torch port's performance-to-layout tail (``repro_torch.core.gatesim``,
``netlist``, ``layout``; paper §III-D) against the JAX package's, on the CPU.

* RTL (``emit_verilog``), DEF (``place`` -> ``emit_def``) and the SDP script
  (``emit_sdp_script``): **byte-equal** to the reference's, for the
  reference chip design (in process: the scalar layer of ``repro.core``
  imports under the installed jax) and for every design on the four
  scenario frontiers (the reference's frontiers come from its batched
  engine, run once in a subprocess with the ``enable_x64`` shim);
* ``build_netlist`` / ``tree_netlist``: the same gates; ``simulate``: the
  same int64 outputs on seeded operands, equal to the lane sums;
* the floorplan's geometric invariants of ``tests/test_layout.py``;
* ``examples/torch_quickstart.py --device cpu`` against
  ``examples/quickstart.py``: the same spec, library, frontier lines,
  chosen design, evaluated count and ``PASS``.  The audit trail and with it
  the RTL's line count are the batched search's, held against the JAX
  package's batched search of the same spec: the batched replay records
  one audit line where the scalar search records each transform.
"""

import dataclasses
import enum
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
from repro.core import csa as R_csa
from repro.core import gatesim as R_gatesim
from repro.core import layout as R_layout
from repro.core import macro as R_macro
from repro.core import netlist as R_netlist

import repro_torch.core as C
from repro_torch.core import csa as C_csa
from repro_torch.core import gatesim, layout, netlist

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
RESOLUTION = 3

REFERENCE_SCRIPT = r"""
import json, sys
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.core import (MacroSpec, calibrated_tech_for_reference,
                        emit_verilog)
from repro.core.batched import mso_search_batched
from repro.core.layout import emit_def, emit_sdp_script, place
from repro.core.multispec import mso_search_many, scenario_specs

tech = calibrated_tech_for_reference()
scen = scenario_specs()
results = mso_search_many(list(scen.values()), tech=tech,
                          resolution=int(sys.argv[2]))
frontiers = {
    name: [{"design": p.design.name(), "rtl": emit_verilog(p),
            "def": emit_def(place(p)), "sdp": emit_sdp_script(p)}
           for p in r.frontier]
    for name, r in zip(scen, results)}
# the quickstart's spec and choice, through the batched search
spec = MacroSpec(h=64, w=64, mcr=2, int_precisions=(4, 8),
                 fp_precisions=("FP4", "FP8"), f_mac_hz=800e6,
                 f_wupdate_hz=800e6, vdd=0.9)
res = mso_search_batched(spec, None, tech)
chosen = max(res.frontier, key=lambda p: p.tops_per_w_1b["int_lo"])
quick = {"chosen": chosen.design.name(), "audit": list(chosen.design.audit),
         "rtl_lines": len(emit_verilog(chosen).splitlines()),
         "n_evaluated": res.n_evaluated}
json.dump({"frontiers": frontiers, "quickstart": quick},
          open(sys.argv[1], "w"))
"""


def _env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO / "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's batched engine, run once in a subprocess."""
    out = tmp_path_factory.mktemp("jax_layout") / "reference.json"
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(out), str(RESOLUTION)],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_frontiers():
    tech = C.calibrated_tech_for_reference()
    scen = C.scenario_specs()
    results = C.mso_search_many(list(scen.values()), tech=tech,
                                resolution=RESOLUTION, device=CPU)
    return {name: r.frontier for name, r in zip(scen, results)}


_REF_CLASSES = {c.__name__: c for c in (
    R_macro.MacroDesign, R_macro.MacroSpec, R_csa.CSADesign,
    R.MemCellKind, R.MultMuxKind)}


def to_ref(obj):
    """A port value rebuilt as the reference package's value."""
    if isinstance(obj, enum.Enum):
        return _REF_CLASSES[type(obj).__name__][obj.name]
    if dataclasses.is_dataclass(obj):
        cls = _REF_CLASSES[type(obj).__name__]
        return cls(**{f.name: to_ref(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(to_ref(x) for x in obj)
    return obj


# ---------------------------------------------------------------------------
# RTL, DEF and SDP text
# ---------------------------------------------------------------------------


class TestReferenceChipText:
    def test_rtl_byte_equal(self):
        assert C.emit_verilog(C.reference_chip_ppa()) == \
            R.emit_verilog(R.reference_chip_ppa())

    def test_def_byte_equal(self):
        assert layout.emit_def(layout.place(C.reference_chip_ppa())) == \
            R_layout.emit_def(R_layout.place(R.reference_chip_ppa()))

    def test_def_design_name_passes_through(self):
        fp = layout.place(C.reference_chip_ppa())
        assert layout.emit_def(fp, name="macro_a") == \
            R_layout.emit_def(R_layout.place(R.reference_chip_ppa()),
                              name="macro_a")

    def test_sdp_script_byte_equal(self):
        assert layout.emit_sdp_script(C.reference_chip_ppa()) == \
            R_layout.emit_sdp_script(R.reference_chip_ppa())

    def test_floorplan_regions_equal(self):
        got = layout.place(C.reference_chip_ppa())
        want = R_layout.place(R.reference_chip_ppa())
        assert (got.die_w, got.die_h) == (want.die_w, want.die_h)
        assert [dataclasses.astuple(r) for r in got.regions] == \
            [dataclasses.astuple(r) for r in want.regions]
        assert got.utilization == want.utilization


SCENARIOS = ("vision", "language", "cloud", "wearable")


class TestScenarioFrontierText:
    @pytest.mark.parametrize("name", SCENARIOS)
    def test_same_frontier_designs(self, name, reference, port_frontiers):
        assert [p.design.name() for p in port_frontiers[name]] == \
            [d["design"] for d in reference["frontiers"][name]]

    @pytest.mark.parametrize("name", SCENARIOS)
    @pytest.mark.parametrize("what", ["rtl", "def", "sdp"])
    def test_text_byte_equal(self, name, what, reference, port_frontiers):
        emit = {"rtl": C.emit_verilog,
                "def": lambda p: layout.emit_def(layout.place(p)),
                "sdp": layout.emit_sdp_script}[what]
        got = [emit(p) for p in port_frontiers[name]]
        want = [d[what] for d in reference["frontiers"][name]]
        assert len(got) == len(want) > 0
        assert got == want


# ---------------------------------------------------------------------------
# Netlists and gate-level simulation
# ---------------------------------------------------------------------------


def _gates(nl):
    return [(g.kind, list(g.ins), list(g.outs)) for g in nl.gates]


NETLIST_CASES = [(i, h) for i in (0, 3, 6, 9, 12, 15, 19)
                 for h in (1, 2, 5, 16, 64, 128)]


class TestNetlist:
    @pytest.mark.parametrize("fam_i,h", NETLIST_CASES)
    def test_build_netlist_same_gates(self, fam_i, h):
        design = C_csa.FAMILY[fam_i]
        got = C.build_netlist(design, h)
        want = R.build_netlist(to_ref(design), h)
        assert got.n_inputs == want.n_inputs
        assert got.outputs == want.outputs
        assert _gates(got) == _gates(want)

    @pytest.mark.parametrize("name", SCENARIOS)
    def test_tree_netlist_of_frontier_designs(self, name, port_frontiers):
        for p in port_frontiers[name]:
            got = netlist.tree_netlist(p.design)
            want = R_netlist.tree_netlist(to_ref(p.design))
            assert _gates(got) == _gates(want)

    @pytest.mark.parametrize("fam_i,h", NETLIST_CASES)
    def test_simulate_equal_and_exact(self, fam_i, h):
        design = C_csa.FAMILY[fam_i]
        rng = np.random.default_rng(fam_i * 1000 + h)
        ops = rng.integers(-(2 ** 40), 2 ** 40, size=(h, 37))
        got = gatesim.simulate(C.build_netlist(design, h), ops)
        want = R_gatesim.simulate(R.build_netlist(to_ref(design), h), ops)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ops.sum(axis=0))

    @pytest.mark.parametrize("split", [1, 2, 4])
    def test_verify_tree_split_designs(self, split):
        design = dataclasses.replace(C_csa.FAMILY[5], split=split)
        nl = C.build_netlist(design, 64 // split)
        ops = np.random.default_rng(split).integers(-8, 8, (nl.n_inputs, 9))
        assert C.verify_tree(nl, ops)
        assert R.verify_tree(R.build_netlist(to_ref(design), 64 // split),
                             ops)

    def test_simulate_rejects_wrong_lane_count(self):
        nl = C.build_netlist(C_csa.FAMILY[0], 8)
        with pytest.raises(ValueError, match="expects 8 operand lanes"):
            gatesim.simulate(nl, np.zeros((7, 3), np.int64))


# ---------------------------------------------------------------------------
# Floorplan invariants (tests/test_layout.py on the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_fp():
    return layout.place(C.reference_chip_ppa())


class TestFloorplan:
    def test_no_overlaps(self, chip_fp):
        rs = chip_fp.regions
        for i, a in enumerate(rs):
            for b in rs[i + 1:]:
                assert not a.overlaps(b), (a.name, b.name)

    def test_regions_inside_die(self, chip_fp):
        for r in chip_fp.regions:
            assert r.x >= -1e-6 and r.y >= -1e-6
            assert r.x + r.w <= chip_fp.die_w + 1e-6
            assert r.y + r.h <= chip_fp.die_h + 1e-6

    def test_die_matches_fig10_footprint(self, chip_fp):
        assert chip_fp.die_w * chip_fp.die_h == \
            pytest.approx(0.112e6, rel=0.02)
        assert 1.2 < chip_fp.die_w / chip_fp.die_h < 2.6

    def test_region_lookup(self, chip_fp):
        assert chip_fp.region("ofu_align").name == "ofu_align"
        with pytest.raises(KeyError):
            chip_fp.region("nope")

    @pytest.mark.parametrize("name", SCENARIOS)
    def test_every_frontier_design_places(self, name, port_frontiers):
        for ppa in port_frontiers[name]:
            assert layout.place(ppa).utilization > 0.9


# ---------------------------------------------------------------------------
# The quickstart
# ---------------------------------------------------------------------------


def _run(script: str, *args: str) -> list[str]:
    proc = subprocess.run([sys.executable, str(REPO / script), *args],
                          env=_env(), capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


@pytest.fixture(scope="module")
def quickstarts():
    return (_run("examples/quickstart.py"),
            _run("examples/torch_quickstart.py", "--device", CPU))


def _audit_span(lines):
    start = lines.index("  searcher audit trail:") + 1
    end = start
    while end < len(lines) and lines[end].startswith("    - "):
        end += 1
    return start, end


class TestQuickstart:
    def test_same_output_but_the_audit_trail(self, quickstarts):
        ref, port = quickstarts
        rs, re_ = _audit_span(ref)
        ps, pe = _audit_span(port)
        assert port[:ps] == ref[:rs]          # spec .. frontier .. chosen
        assert port[pe:-2] == ref[re_:-2]
        assert port[-1] == ref[-1]
        assert port[-1].endswith("PASS")

    def test_audit_and_rtl_are_the_batched_search(self, quickstarts,
                                                  reference):
        _, port = quickstarts
        want = reference["quickstart"]
        ps, pe = _audit_span(port)
        assert [ln[len("    - "):] for ln in port[ps:pe]] == want["audit"]
        assert f"chosen: {want['chosen']}" in port
        assert f"emitted RTL: {want['rtl_lines']} lines " \
               "(module dcim_macro)" in port
        assert f"MSO search: {want['n_evaluated']} designs evaluated," \
            in " ".join(port)
