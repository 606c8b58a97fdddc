"""The torch port's serving-time macro selection (``repro_torch.serve``)
against the JAX package's ``repro.serve``, on the CPU.

The reference's ``serve.select`` imports its engine, so it runs once per
module in a subprocess with the ``enable_x64`` shim: ``select_macros`` on
the four scenario specs for the qwen3-4b and zamba2-1.2b GEMM inventories
(full width, every layer), without a preference, with one, with a profile
(named workloads, a default, an explicit wallclock-only entry) and with a
measured kernel fraction.  The port must pick the same macro from the same
pool, with the same labels, and report the same serving bound: tokens/s
and every time of the estimate bit for bit (``repr`` of a float
round-trips).  The subprocess sets the reference's
``roofline.hw.HBM_BW`` to the port's (the H100's, not the TPU's), as
``tests/test_torch_serving.py`` does, so ``t_hbm_s`` compares too.  The
``ServeConfig`` and ``PreferenceProfile`` artifacts each
package writes are the same bytes, and each package reads the other's.
"""

import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys

import pytest

import repro_torch.core as C
from repro_torch.configs import get_config
from repro_torch.roofline import hw as port_hw
from repro_torch.serve import select_macros
from repro_torch.serve.config import (ServeConfig, load_serve_config,
                                      save_serve_config)
from repro_torch.serve.select import (PreferenceProfile, apply_profile,
                                      load_preference_profile,
                                      preference_select,
                                      save_preference_profile)
from repro_torch.service import SynthesisService

REPO = pathlib.Path(__file__).resolve().parents[1]
RES = 3
ARCHS = ("qwen3-4b", "zamba2-1.2b")


def cases(PreferenceProfile):
    """Selection cases by name: keyword arguments of ``select_macros``."""
    return {
        "wallclock": {},
        "preference": {"preference": (0.2, 0.6, 0.2)},
        "area_leaning": {"preference": (0.1, 0.1, 0.8)},
        "profile": {"preference": (1.0, 0.0, 0.0), "profile":
                    PreferenceProfile(
                        workloads={"qwen3-4b": (0.2, 0.6, 0.2),
                                   "zamba2-1.2b": None})},
        "profile_default": {"profile": PreferenceProfile(
            workloads={"zamba2-1.2b": (0.0, 1.0, 0.0)},
            default=(0.3, 0.3, 0.4))},
        "kernel_fraction": {"preference": (0.2, 0.6, 0.2),
                            "kernel_fraction": 0.937238},
    }


def selection_record(sel) -> dict:
    """What a selection decided, as text that is equal only when the
    floats are equal bit for bit."""
    return {
        "scenarios": list(sel.scenarios),
        "pool_labels": list(sel.pool_labels),
        "assignment": dict(sel.assignment),
        "preference": repr(sel.preference),
        "preferences_applied": repr(sorted(sel.preferences_applied
                                           .items())),
        "codesign_frontier": list(sel.codesign.frontier),
        "serving": {w: repr(sorted(dataclasses.asdict(e).items()))
                    for w, e in sel.serving.items()},
        "summary": json.dumps(sel.summary(), sort_keys=True),
    }


def artifact_inputs(ServeConfig, PreferenceProfile):
    config = ServeConfig(select=True, pref=(0.2, 0.6, 0.2),
                         profile="deploy/profile.json", cache="frontiers",
                         registry="shared/registry", macros=128,
                         trace="trace.json", trace_sample=0.25,
                         kernel_profile="kp.json")
    profile = PreferenceProfile(
        workloads={"zamba2-1.2b": (0.1, 0.7, 0.2), "qwen3-4b": None},
        default=(1.0, 0.0, 0.0))
    return config, profile


REFERENCE_SCRIPT = r"""
import dataclasses, json, pathlib, sys
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.configs import get_config
from repro.core.dse import gemm_inventory
from repro.roofline import hw
from repro.serve.config import (ServeConfig, load_serve_config,
                                save_serve_config)
from repro.serve.select import (PreferenceProfile, load_preference_profile,
                                save_preference_profile, select_macros)
from repro.service import SynthesisService

""" + (inspect.getsource(cases) + inspect.getsource(selection_record)
       + inspect.getsource(artifact_inputs)) + r"""
out = pathlib.Path(sys.argv[1])
hw.HBM_BW = float(sys.argv[4])
workloads = {a: gemm_inventory(get_config(a)) for a in sys.argv[2].split(",")}
svc = SynthesisService(resolution=int(sys.argv[3]))
records = {name: selection_record(select_macros(
               workloads, resolution=int(sys.argv[3]), service=svc, **kw))
           for name, kw in cases(PreferenceProfile).items()}
config, profile = artifact_inputs(ServeConfig, PreferenceProfile)
save_serve_config(out / "jax_serve.json", config)
save_preference_profile(out / "jax_profile.json", profile)
# the port's artifacts, read by the reference
port_config = load_serve_config(out / "port_serve.json")
port_profile = load_preference_profile(out / "port_profile.json")
(out / "reference.json").write_text(json.dumps({
    "records": records,
    "reads_port_config": port_config == config,
    "reads_port_profile": port_profile == profile,
}))
"""


@pytest.fixture(scope="module")
def workloads():
    return {a: C.gemm_inventory(get_config(a)) for a in ARCHS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_select")
    config, profile = artifact_inputs(ServeConfig, PreferenceProfile)
    save_serve_config(out / "port_serve.json", config)
    save_preference_profile(out / "port_profile.json", profile)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(out), ",".join(ARCHS),
         str(RES), repr(port_hw.HBM_BW)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, json.loads((out / "reference.json").read_text())


@pytest.fixture(scope="module")
def port_service():
    return SynthesisService(resolution=RES, device="cpu")


CASES = tuple(cases(PreferenceProfile))


class TestSelectMacros:
    @pytest.mark.parametrize("case", CASES)
    def test_same_selection(self, case, reference, workloads, port_service):
        _, ref = reference
        sel = select_macros(workloads, resolution=RES, service=port_service,
                            **cases(PreferenceProfile)[case])
        got = selection_record(sel)
        want = ref["records"][case]
        assert got["pool_labels"] == want["pool_labels"]
        assert got["assignment"] == want["assignment"]
        assert got["preferences_applied"] == want["preferences_applied"]
        assert got["codesign_frontier"] == want["codesign_frontier"]
        assert got["serving"] == want["serving"]         # tokens/s included
        assert got == want

    def test_cases_pick_more_than_one_macro(self, reference):
        """The cases are not degenerate: the preferences move the pick."""
        _, ref = reference
        picks = {json.dumps(r["assignment"], sort_keys=True)
                 for r in ref["records"].values()}
        assert len(picks) > 1

    def test_kernel_fraction_derates_tokens(self, workloads, port_service):
        kw = cases(PreferenceProfile)["kernel_fraction"]
        full = select_macros(workloads, resolution=RES, service=port_service,
                             preference=kw["preference"])
        derated = select_macros(workloads, resolution=RES,
                                service=port_service, **kw)
        assert derated.assignment == full.assignment
        for w in ARCHS:
            assert derated.serving[w].tokens_per_s < \
                full.serving[w].tokens_per_s

    def test_apply_profile_round_trip(self, tmp_path, workloads,
                                      port_service):
        path = tmp_path / "profile.json"
        sel, updated = apply_profile(path, lambda profile: select_macros(
            workloads, resolution=RES, service=port_service,
            preference=(0.2, 0.6, 0.2), profile=profile))
        assert updated.workloads == {w: (0.2, 0.6, 0.2) for w in ARCHS}
        assert load_preference_profile(path) == updated
        assert sel.preferences_applied == updated.workloads

    def test_preference_select_is_scale_free(self, reference, workloads,
                                             port_service):
        sel = select_macros(workloads, resolution=RES, service=port_service)
        report = sel.codesign
        wi = report.workloads.index("qwen3-4b")
        import numpy as np
        objs = np.stack([report.wallclock_s[wi], report.energy_pj[wi],
                         report.area_mm2], axis=1)
        assert preference_select(objs, (0.2, 0.6, 0.2)) == \
            preference_select(objs, (2.0, 6.0, 2.0))


class TestArtifacts:
    @pytest.mark.parametrize("name", ["serve", "profile"])
    def test_port_artifact_bytes_equal_reference(self, name, reference):
        out, _ = reference
        assert (out / f"port_{name}.json").read_bytes() == \
            (out / f"jax_{name}.json").read_bytes()

    def test_reference_reads_port_artifacts(self, reference):
        _, ref = reference
        assert ref["reads_port_config"] and ref["reads_port_profile"]

    def test_port_reads_reference_artifacts(self, reference):
        out, _ = reference
        config, profile = artifact_inputs(ServeConfig, PreferenceProfile)
        assert load_serve_config(out / "jax_serve.json") == config
        assert load_preference_profile(out / "jax_profile.json") == profile
