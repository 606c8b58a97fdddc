"""The torch port's synthesis service (``repro_torch.service``) against the
JAX package's ``repro.service``, on the CPU.

Against the reference, whose service imports its engine and so runs in one
module-scoped subprocess with the ``enable_x64`` shim:

* every content address (``spec_key``, ``canonical_spec``,
  ``lattice_signature``, ``axis_signatures``, ``cache_key``, ``sweep_key``,
  ``slice_key``, ``key_scope``, ``stale_digests``) is the same string: no
  device, torch version or backend goes into a frontier key;
* the frontier artifacts are the same bytes: each result's JSON payload,
  and every file each package's service writes into its local store and
  its shared registry (artifacts, scope records);
* a store written by the JAX package is served by the port as hits with
  zero engine passes and equal results, and the reverse.

Then the contracts of the reference's service tests, restated for the port
on ``device="cpu"``: ``tests/test_service.py`` (``TestKeys``,
``TestCacheHitIdentity``, ``TestCoalescing``, ``TestDiskStore``,
``TestApplyProfile``), ``tests/test_registry.py`` (``TestAtomicWriters``,
``TestQuarantine``, ``TestStatsAccounting``, ``TestRegistryProtocol``,
``TestThreeTierLookup``, ``TestSharedServiceDrill``,
``TestScopedInvalidation``, ``TestMultiProcessStress``,
``TestClaimContention``, ``TestTwoProcessDrill``),
``tests/test_frontend.py`` (``TestTypedRequestAPI``,
``TestDeprecationShims``, ``TestLifecycle``, ``TestPriorityOrdering``,
``TestBackpressure``, ``TestStreaming``, ``TestThreadedFrontend``,
``TestServeConfig``, ``TestSingletonThreadSafety``) and the service and
frontend span checks of ``tests/test_obs.py``.  The multi-process drills
start fewer workers than the reference's (each imports torch).
``TestMultiHostStrategy`` and ``TestAsyncEightDevices`` wait for the port's
sharded engine (ROADMAP.md queue 1, item 4): every sharded service mode
raises ``NotImplementedError`` naming it, which is tested here instead.
"""

import dataclasses
import functools
import inspect
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from argparse import Namespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.core as C
from repro_torch.core import engine
from repro_torch.core import subcircuits as sc
from repro_torch.core.axes import LatticeConfig, seed_config
from repro_torch.core.macro import MacroSpec
from repro_torch.core.multispec import frontier_union, mso_search_many
from repro_torch.obs import configure, tracer
from repro_torch.serve.config import (SERVE_CONFIG_SCHEMA, ServeConfig,
                                      load_serve_config, parse_pref,
                                      save_serve_config,
                                      serve_config_from_args)
from repro_torch.serve.select import (apply_profile, load_preference_profile,
                                      select_macros)
from repro_torch.service import (FRONTIER_EVENT, SERVICE_MODES,
                                 ArtifactRegistry, CacheArtifactError,
                                 FrontierCache, Priority, RequestState,
                                 ServiceFrontend, SheddedResponse,
                                 SynthesisRequest, SynthesisResponse,
                                 SynthesisService, cache_key, get_service,
                                 key_scope, keys, lattice_signature,
                                 load_artifact, reset_service,
                                 resolve_service_mode, result_from_payload,
                                 result_to_payload, slice_key, spec_key,
                                 stale_digests)
from repro_torch.service import service as service_mod
from repro_torch.service.cache import CacheStats
from repro_torch.service.frontend import WINDOW_BOUNDS, FrontendStats
from repro_torch.service.registry import RegistryStats
from repro_torch.service.service import ServiceStats

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
RES = 3
TECH = C.calibrated_tech_for_reference()

#: The message every sharded service mode raises with.
SHARDED_QUEUE = "queue 1, item 4"


# The JAX package's ``core.shardspec.spec_variants`` (the port's sharded
# slice has not brought it yet): n seeded posture variants of a base spec.
_VARIANT_F_MAC = (250e6, 400e6, 600e6, 800e6, 1.0e9, 1.1e9)
_VARIANT_VDD = (0.7, 0.8, 0.9, 1.0, 1.1, 1.2)
_VARIANT_MCR = (1, 2, 4)


def spec_variants(n: int, seed: int = 0) -> list[MacroSpec]:
    base = C.scenario_specs()["vision"]
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < n:
        f_mac = float(rng.choice(_VARIANT_F_MAC))
        f_wup = float(min(f_mac, rng.choice(_VARIANT_F_MAC)))
        vdd = float(rng.choice(_VARIANT_VDD))
        mcr = int(rng.choice(_VARIANT_MCR))
        key = (f_mac, f_wup, vdd, mcr)
        if key in seen:
            continue
        seen.add(key)
        out.append(dataclasses.replace(base, f_mac_hz=f_mac,
                                       f_wupdate_hz=f_wup, vdd=vdd, mcr=mcr))
    return out


def service(**kw) -> SynthesisService:
    kw.setdefault("tech", TECH)
    kw.setdefault("resolution", RES)
    return SynthesisService(device=CPU, **kw)


@pytest.fixture()
def execute_counter():
    calls = []
    engine.add_execute_hook(calls.append)
    yield calls
    engine.remove_execute_hook(calls.append)


def assert_ppa_equal(a, b):
    assert a.design.name() == b.design.name()
    assert a.paths == b.paths
    assert a.fmax_hz == b.fmax_hz
    assert a.area_um2 == b.area_um2
    assert a.area_breakdown == b.area_breakdown
    assert a.e_cycle_fj == b.e_cycle_fj
    assert a.latency_cycles == b.latency_cycles
    assert a.tops_1b == b.tops_1b
    assert a.tops_per_w_1b == b.tops_per_w_1b
    assert a.tops_per_mm2_1b == b.tops_per_mm2_1b
    assert a.meets_timing == b.meets_timing


def assert_search_identical(got, oracle):
    assert got.spec == oracle.spec
    assert got.n_evaluated == oracle.n_evaluated
    assert [p.design.name() for p in got.explored] == \
           [p.design.name() for p in oracle.explored]
    assert len(got.frontier) == len(oracle.frontier)
    for x, y in zip(got.frontier, oracle.frontier):
        assert_ppa_equal(x, y)


def oracle(specs, resolution=RES, tech=TECH):
    return mso_search_many(specs, None, tech, resolution=resolution,
                           device=CPU)


# ---------------------------------------------------------------------------
# Against the JAX package (one subprocess per module)
# ---------------------------------------------------------------------------


def key_table(keys, MacroSpec, TechModel, LatticeConfig, sc, spec_cases,
              tech_cases):
    """Every content address over the cases, as plain JSON data; the same
    function runs on both packages' ``service.keys``."""
    specs = [MacroSpec(**{**d, "int_precisions": tuple(d["int_precisions"]),
                          "fp_precisions": tuple(d["fp_precisions"])})
             for d in spec_cases]
    techs = {n: TechModel(**d) for n, d in tech_cases.items()}
    configs = {
        "seed": None,
        "two_memcells": LatticeConfig(memcells=(sc.MemCellKind.SRAM_6T,
                                                sc.MemCellKind.DLATCH_8T)),
        "full": LatticeConfig(precision_modes=3,
                              approx_cells=sc.APPROX_CELLS)}
    base = techs["calibrated"]
    out = {}
    for i, s in enumerate(specs):
        out[f"spec_key/{i}"] = keys.spec_key(s)
        out[f"canonical_spec/{i}"] = json.dumps(keys.canonical_spec(s))
    for tn, t in techs.items():
        for cn, cfg in configs.items():
            tag = f"{tn}/{cn}"
            out[f"lattice_signature/{tag}"] = keys.lattice_signature(
                t, config=cfg)
            out[f"axis_signatures/{tag}"] = keys.axis_signatures(t, cfg)
            out[f"key_scope/{tag}"] = keys.key_scope(t, cfg)
            for axis, values in keys.axis_value_payloads(t, cfg).items():
                for v in range(len(values)):
                    out[f"key_scope/{tag}/{axis}/{v}"] = keys.key_scope(
                        t, cfg, axis=axis, value_index=v)
                    out[f"slice_key/{tag}/{axis}/{v}"] = keys.slice_key(
                        specs[0], t, axis, v, config=cfg)
            out[f"stale_digests/{tag}"] = sorted(
                keys.stale_digests(base, t, cfg))
            for i, s in enumerate(specs):
                out[f"cache_key/{i}/{tag}"] = keys.cache_key(
                    s, t, resolution=3, config=cfg)
                out[f"sweep_key/{i}/{tag}"] = keys.sweep_key(s, t, cfg)
    out["cache_key/eps"] = keys.cache_key(specs[0], base, resolution=4,
                                          eps=1e-9)
    out["cache_key/memcells"] = keys.cache_key(
        specs[0], base, (sc.MemCellKind.SRAM_6T,), 5)
    out["stale_digests/config_change"] = sorted(keys.stale_digests(
        base, base, None, new_config=configs["two_memcells"]))
    return out


def make_requests(SynthesisRequest, MacroSpec, LatticeConfig, sc,
                  spec_cases):
    """The request batch both packages' services serve: a search per spec
    case (two of them duplicated) and an exhaustive sweep over a lattice
    with the approximate-cell axis."""
    specs = [MacroSpec(**{**d, "int_precisions": tuple(d["int_precisions"]),
                          "fp_precisions": tuple(d["fp_precisions"])})
             for d in spec_cases]
    sweep_cfg = LatticeConfig(memcells=(sc.MemCellKind.SRAM_6T,),
                              approx_cells=sc.APPROX_CELLS[:2])
    return ([SynthesisRequest(spec=s) for s in specs]
            + [SynthesisRequest(spec=specs[0]),
               SynthesisRequest(spec=specs[2])]
            + [SynthesisRequest(spec=specs[1], kind="sweep",
                                config=sweep_cfg)])


REFERENCE_SCRIPT = r"""
import dataclasses, json, pathlib, sys
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.core import engine
from repro.core import subcircuits as sc
from repro.core.axes import LatticeConfig
from repro.core.macro import MacroSpec
from repro.core.tech import TechModel
from repro.service import (ArtifactRegistry, FrontierCache,
                           SynthesisRequest, SynthesisService, keys)
from repro.service.artifacts import result_to_payload

""" + inspect.getsource(key_table) + inspect.getsource(make_requests) + r"""
out_dir = pathlib.Path(sys.argv[1])
cases = json.loads(pathlib.Path(sys.argv[2]).read_text())
port_store, port_registry = sys.argv[3], sys.argv[4]
calls = []
engine.add_execute_hook(calls.append)
out = {"keys": key_table(keys, MacroSpec, TechModel, LatticeConfig, sc,
                         cases["specs"], cases["techs"])}
reqs = make_requests(SynthesisRequest, MacroSpec, LatticeConfig, sc,
                     cases["specs"])


def run(cache):
    n0 = len(calls)
    svc = SynthesisService(resolution=3, cache=cache)
    resp = svc.serve(reqs)
    return {"executes": len(calls) - n0, "telemetry": svc.telemetry(),
            "served_from": [r.served_from for r in resp],
            "results": [json.dumps(result_to_payload(r.result))
                        for r in resp]}


out["fresh"] = run(FrontierCache(store_dir=out_dir / "store",
                                 registry=ArtifactRegistry(out_dir / "reg")))
out["from_port_store"] = run(FrontierCache(store_dir=port_store))
out["from_port_registry"] = run(FrontierCache(
    registry=ArtifactRegistry(port_registry)))
(out_dir / "reference.json").write_text(json.dumps(out))
"""


def _cases() -> dict:
    specs = (list(C.scenario_specs().values()) + [MacroSpec()]
             + spec_variants(3, seed=4))
    techs = {"calibrated": TECH,
             "tau": dataclasses.replace(TECH, tau_ps=TECH.tau_ps * 1.01),
             "a_sram8t": dataclasses.replace(TECH,
                                             a_sram8t=TECH.a_sram8t * 1.05)}
    return {"specs": [dataclasses.asdict(s) for s in specs],
            "techs": {n: dataclasses.asdict(t) for n, t in techs.items()}}


def _env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO / "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _run_port(cache, reqs):
    calls = []
    engine.add_execute_hook(calls.append)
    try:
        svc = service(cache=cache)
        resp = svc.serve(reqs)
    finally:
        engine.remove_execute_hook(calls.append)
    return {"executes": len(calls), "telemetry": svc.telemetry(),
            "served_from": [r.served_from for r in resp],
            "results": [json.dumps(result_to_payload(r.result))
                        for r in resp]}


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port serves the batch into its own store; then the JAX package,
    in a subprocess, computes its key table, serves the same batch into
    its store, and serves the batch again from the port's store and from
    the port's registry."""
    root = tmp_path_factory.mktemp("cross_package")
    cases = _cases()
    (root / "cases.json").write_text(json.dumps(cases))
    reqs = make_requests(SynthesisRequest, MacroSpec, LatticeConfig, sc,
                         cases["specs"])
    port = {"keys": key_table(keys, MacroSpec, C.TechModel, LatticeConfig,
                              sc, cases["specs"], cases["techs"]),
            "fresh": _run_port(FrontierCache(
                store_dir=root / "port_store",
                registry=ArtifactRegistry(root / "port_reg")), reqs)}
    jax_dir = root / "jax"
    jax_dir.mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(jax_dir),
         str(root / "cases.json"), str(root / "port_store"),
         str(root / "port_reg")],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads((jax_dir / "reference.json").read_text())
    port["from_jax_store"] = _run_port(
        FrontierCache(store_dir=jax_dir / "store"), reqs)
    port["from_jax_registry"] = _run_port(
        FrontierCache(registry=ArtifactRegistry(jax_dir / "reg")), reqs)
    return {"port": port, "ref": ref, "root": root, "jax_dir": jax_dir,
            "n_requests": len(reqs)}


KEY_FAMILIES = ("spec_key", "canonical_spec", "lattice_signature",
                "axis_signatures", "key_scope", "slice_key", "stale_digests",
                "cache_key", "sweep_key")


class TestAgainstReference:
    @pytest.mark.parametrize("family", KEY_FAMILIES)
    def test_keys_equal(self, cross, family):
        got = {k: v for k, v in cross["port"]["keys"].items()
               if k.split("/")[0] == family}
        want = {k: v for k, v in cross["ref"]["keys"].items()
                if k.split("/")[0] == family}
        assert got and got == want

    def test_key_table_separates_ingredients(self, cross):
        """The cases differ where they should: 8 specs, 3 techs and 3
        configs give distinct search addresses."""
        addrs = [v for k, v in cross["port"]["keys"].items()
                 if k.startswith("cache_key/") and k.count("/") == 3]
        assert len(addrs) == len(set(addrs)) == 8 * 3 * 3

    def test_artifact_json_byte_equal(self, cross):
        got, want = cross["port"]["fresh"], cross["ref"]["fresh"]
        assert got["served_from"] == want["served_from"]
        assert got["results"] == want["results"]

    def test_fresh_pass_accounting_equal(self, cross):
        got, want = cross["port"]["fresh"], cross["ref"]["fresh"]
        assert got["telemetry"] == want["telemetry"]
        assert got["telemetry"]["service"]["fused_passes"] == 1
        assert got["telemetry"]["service"]["coalesced"] == 2

    @pytest.mark.parametrize("port_where,jax_where", [
        ("port_store", "store"), ("port_reg/objects", "reg/objects")])
    def test_store_files_byte_equal(self, cross, port_where, jax_where):
        port_dir = cross["root"] / port_where
        jax_dir = cross["jax_dir"] / jax_where
        names = sorted(p.name for p in port_dir.iterdir())
        assert names == sorted(p.name for p in jax_dir.iterdir())
        assert len(names) > cross["n_requests"]
        for n in names:
            assert (port_dir / n).read_bytes() == (jax_dir / n).read_bytes(), n

    @pytest.mark.parametrize("run", ["from_port_store",
                                     "from_port_registry"])
    def test_jax_serves_port_store_warm(self, cross, run):
        got = cross["ref"][run]
        assert got["executes"] == 0
        assert got["telemetry"]["service"]["fused_passes"] == 0
        assert got["telemetry"]["service"]["misses"] == 0
        assert set(got["served_from"]) == {"cache"}
        assert got["results"] == cross["ref"]["fresh"]["results"]

    @pytest.mark.parametrize("run", ["from_jax_store", "from_jax_registry"])
    def test_port_serves_jax_store_warm(self, cross, run):
        got = cross["port"][run]
        assert got["executes"] == 0
        assert got["telemetry"]["service"]["fused_passes"] == 0
        assert got["telemetry"]["service"]["misses"] == 0
        assert set(got["served_from"]) == {"cache"}
        assert got["results"] == cross["port"]["fresh"]["results"]


# ---------------------------------------------------------------------------
# Service modes and the device
# ---------------------------------------------------------------------------


SHARDED_SERVICE_MODES = ("sharded", "jit", "pmap", "multihost")


class TestServiceModes:
    def test_modes_are_the_reference_set(self):
        assert SERVICE_MODES == ("auto", "vmap") + SHARDED_SERVICE_MODES

    @pytest.mark.parametrize("mode", SHARDED_SERVICE_MODES)
    def test_sharded_mode_raises_naming_the_queue(self, mode):
        with pytest.raises(NotImplementedError, match=SHARDED_QUEUE):
            resolve_service_mode(mode)
        with pytest.raises(NotImplementedError, match=SHARDED_QUEUE):
            SynthesisService(device=CPU, mode=mode)

    @pytest.mark.parametrize("mode", SHARDED_SERVICE_MODES)
    def test_sharded_request_mode_raises_never_vmap(self, mode,
                                                    execute_counter):
        svc = service()
        with pytest.raises(NotImplementedError, match=SHARDED_QUEUE):
            svc.serve([SynthesisRequest(spec=spec_variants(1, 3)[0],
                                        mode=mode)])
        assert execute_counter == []
        assert svc.stats.fused_passes == 0

    def test_sharded_request_through_frontend_sheds_typed(self):
        front = ServiceFrontend(service(), start=False)
        try:
            t = front.submit(SynthesisRequest(spec=spec_variants(1, 5)[0],
                                              mode="pmap"))
            front.run_pending()
            resp = t.result(timeout=0)
            assert isinstance(resp, SheddedResponse)
            assert resp.reason == "internal_error"
            assert "NotImplementedError" in resp.detail
            assert SHARDED_QUEUE in resp.detail
        finally:
            front.close()

    def test_auto_on_one_device_is_vmap(self):
        assert resolve_service_mode("auto") == "vmap"
        assert resolve_service_mode("auto", 1000, CPU) == "vmap"
        assert resolve_service_mode("vmap", 1000, CPU) == "vmap"

    def test_auto_across_cards_raises_not_vmap(self, monkeypatch):
        """A batch big enough to shard over 4 cards asks for the sharded
        engine, which is not there yet: an error, never a silent vmap."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setattr(service_mod, "resolve_device",
                            lambda device=None: torch.device("cuda", 0))
        assert resolve_service_mode("auto", 7, "cuda") == "vmap"
        with pytest.raises(NotImplementedError, match=SHARDED_QUEUE):
            resolve_service_mode("auto", 8, "cuda")

    def test_unknown_mode_is_value_error(self):
        with pytest.raises(ValueError, match="unknown service mode"):
            resolve_service_mode("warp-drive")

    def test_device_resolved_once_at_build(self):
        svc = service()
        assert svc.device == torch.device("cpu")

    def test_get_service_without_card_raises(self, monkeypatch):
        reset_service()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        try:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                get_service()
            assert service_mod._DEFAULT_SERVICE is None
        finally:
            reset_service()

    def test_service_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SynthesisService()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ServiceFrontend(start=False)

    def test_frontend_scheduler_thread_runs_on_service_device(self):
        """The scheduler thread serves on the device the service resolved
        when it was built."""
        svc = service()
        seen = []
        hook = lambda plan: seen.append(plan.placement.device)
        engine.add_execute_hook(hook)
        try:
            with ServiceFrontend(svc, window=0.01) as front:
                front.serve([SynthesisRequest(spec=spec_variants(1, 9)[0])],
                            timeout=300)
        finally:
            engine.remove_execute_hook(hook)
        assert seen == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# tests/test_service.py, restated
# ---------------------------------------------------------------------------


class TestKeys:
    def test_spec_key_deterministic_and_structural(self):
        a = MacroSpec(h=64, w=64, mcr=2, f_mac_hz=800e6)
        b = MacroSpec(h=64, w=64, mcr=2, f_mac_hz=8e8)
        assert spec_key(a) == spec_key(a)
        assert spec_key(a) == spec_key(b)

    def test_spec_key_separates_specs(self):
        specs = spec_variants(12, seed=4) + list(C.scenario_specs().values())
        assert len({spec_key(s) for s in specs}) == len(set(specs))

    def test_cache_key_covers_every_ingredient(self):
        spec = C.scenario_specs()["vision"]
        mc = service().memcells
        base = cache_key(spec, TECH, mc, 4)
        assert base == cache_key(spec, TECH, mc, 4)
        assert cache_key(C.scenario_specs()["cloud"], TECH, mc, 4) != base
        assert cache_key(spec, TECH, mc, 5) != base
        assert cache_key(spec, TECH, mc, 4, eps=1e-9) != base
        bumped = dataclasses.replace(TECH, tau_ps=TECH.tau_ps * 1.01)
        assert cache_key(spec, bumped, mc, 4) != base
        assert lattice_signature(TECH, mc) != lattice_signature(bumped, mc)

    def test_service_key_is_device_free(self, monkeypatch):
        """The service's address of a request names no device: a service
        on another device gives the same key."""
        req = SynthesisRequest(spec=spec_variants(1, 2)[0])
        key = service().key_for(req)
        monkeypatch.setattr(service_mod, "resolve_device",
                            lambda device=None: torch.device("cuda", 0))
        assert service().key_for(req) == key


class TestCacheHitIdentity:
    def test_hit_bit_identical_to_fresh_run(self):
        specs = spec_variants(3, seed=11)
        fresh = oracle(specs)
        svc = service()
        first = svc.serve([SynthesisRequest(spec=s) for s in specs])
        again = svc.serve([SynthesisRequest(spec=s) for s in specs])
        for f, a, b in zip(fresh, first, again):
            assert_search_identical(a.result, f)
            assert_search_identical(b.result, f)
            assert b.served_from == "cache"

    def test_second_call_zero_engine_executions(self, execute_counter):
        spec = spec_variants(1, seed=13)[0]
        svc = service()
        svc.serve([SynthesisRequest(spec=spec)])
        assert len(execute_counter) == 1
        svc.serve([SynthesisRequest(spec=spec)])
        assert len(execute_counter) == 1
        assert svc.stats.cache_hits == 1

    def test_select_macros_memoized_through_cache(self, execute_counter):
        from repro_torch.configs import smoke_config
        workloads = {"qwen3-4b": C.gemm_inventory(smoke_config("qwen3-4b"))}
        svc = service()
        first = select_macros(workloads, tech=TECH, resolution=RES,
                              service=svc)
        n_cold = len(execute_counter)
        assert n_cold >= 1
        second = select_macros(workloads, tech=TECH, resolution=RES,
                               service=svc)
        assert len(execute_counter) == n_cold
        assert second.assignment == first.assignment
        assert second.pool_labels == first.pool_labels
        assert second.summary() == first.summary()


class TestCoalescing:
    def test_n_singletons_one_fused_pass(self, execute_counter):
        specs = spec_variants(5, seed=17)
        ref = [oracle([s])[0] for s in specs]
        n_naive = len(execute_counter)
        assert n_naive == len(specs)
        svc = service()
        got = svc.serve([SynthesisRequest(spec=s) for s in specs])
        assert len(execute_counter) == n_naive + 1
        assert svc.stats.fused_passes == 1
        for g, r in zip(got, ref):
            assert_search_identical(g.result, r)

    def test_duplicates_coalesce_onto_one_miss(self, execute_counter):
        specs = spec_variants(3, seed=19)
        stream = [specs[0], specs[1], specs[0], specs[2], specs[1], specs[0]]
        svc = service()
        got = [r.result for r in
               svc.serve([SynthesisRequest(spec=s) for s in stream])]
        assert len(execute_counter) == 1
        assert svc.stats.misses == 3
        assert svc.stats.coalesced == 3
        assert got[2] is got[0] and got[5] is got[0] and got[4] is got[1]

    def test_mixed_geometry_batch_still_one_execute(self, execute_counter):
        mixed = spec_variants(2, seed=23) + [
            MacroSpec(h=32, w=32, mcr=2, int_precisions=(4, 8),
                      fp_precisions=("FP8",), f_mac_hz=500e6,
                      f_wupdate_hz=500e6, vdd=0.9)]
        ref = oracle(mixed)
        n0 = len(execute_counter)
        svc = service()
        got = svc.serve([SynthesisRequest(spec=s) for s in mixed])
        assert len(execute_counter) == n0 + 1
        assert len(execute_counter[-1].groups) == 2
        for g, r in zip(got, ref):
            assert_search_identical(g.result, r)


class TestDiskStore:
    def test_round_trip_bit_identical(self, tmp_path):
        specs = spec_variants(2, seed=29)
        warm = service(cache=FrontierCache(store_dir=tmp_path))
        first = warm.serve([SynthesisRequest(spec=s) for s in specs])
        cold = service(cache=FrontierCache(store_dir=tmp_path))
        again = cold.serve([SynthesisRequest(spec=s) for s in specs])
        assert cold.stats.misses == 0 and cold.stats.fused_passes == 0
        assert cold.cache.stats.disk_hits == len(specs)
        for a, b in zip(first, again):
            assert_search_identical(b.result, a.result)
            assert dataclasses.asdict(b.result) == \
                dataclasses.asdict(a.result)

    def test_payload_round_trip_is_lossless(self):
        (res,) = oracle(spec_variants(1, seed=31))
        text = json.dumps(result_to_payload(res))
        back = result_from_payload(json.loads(text))
        assert_search_identical(back, res)
        assert back.spec == res.spec
        assert json.dumps(result_to_payload(back)) == text

    def test_payload_holds_only_python_scalars(self):
        """No torch or numpy scalar reaches a payload: every float is a
        Python float, every int a Python int."""
        (res,) = oracle(spec_variants(1, seed=33))

        def walk(x):
            if isinstance(x, dict):
                for v in x.values():
                    yield from walk(v)
            elif isinstance(x, list):
                for v in x:
                    yield from walk(v)
            else:
                yield x
        leaves = list(walk(result_to_payload(res)))
        assert {type(v) for v in leaves} <= {float, int, str, bool,
                                             type(None)}

    @pytest.mark.parametrize("corruption", [
        "not json at all {",
        json.dumps({"schema": "something-else/v1", "key": "k",
                    "result": {}}),
        json.dumps({"schema": "syndcim-frontier-artifact/v1",
                    "key": "k", "result": {"spec": {}}}),
        json.dumps([1, 2, 3]),
    ])
    def test_corrupted_artifact_rejected(self, tmp_path, corruption):
        spec = spec_variants(1, seed=37)[0]
        cache = FrontierCache(store_dir=tmp_path)
        svc = service(cache=cache)
        (ref,) = svc.serve([SynthesisRequest(spec=spec)])
        path = cache.artifact_path(svc.key_for(SynthesisRequest(spec=spec)))
        assert path.exists()
        path.write_text(corruption)
        with pytest.raises(CacheArtifactError):
            FrontierCache.load_artifact(path)
        svc2 = service(cache=FrontierCache(store_dir=tmp_path))
        (got,) = svc2.serve([SynthesisRequest(spec=spec)])
        assert svc2.cache.stats.corrupt == 1
        assert svc2.stats.fused_passes == 1
        assert_search_identical(got.result, ref.result)
        (_, healed) = FrontierCache.load_artifact(path)
        assert_search_identical(healed, ref.result)

    def test_key_mismatch_is_rejected(self, tmp_path):
        specs = spec_variants(2, seed=41)
        cache = FrontierCache(store_dir=tmp_path)
        svc = service(cache=cache)
        svc.serve([SynthesisRequest(spec=s) for s in specs])
        k0, k1 = (svc.key_for(SynthesisRequest(spec=s)) for s in specs)
        os.replace(cache.artifact_path(k0), cache.artifact_path(k1))
        fresh = FrontierCache(store_dir=tmp_path)
        assert fresh.get(k1) is None
        assert fresh.stats.corrupt == 1

    def test_lru_eviction_keeps_disk_copy(self, tmp_path):
        specs = spec_variants(3, seed=43)
        cache = FrontierCache(capacity=1, store_dir=tmp_path)
        svc = service(cache=cache)
        svc.serve([SynthesisRequest(spec=s) for s in specs])
        assert len(cache) == 1
        assert cache.stats.evictions == 2
        ref = oracle(specs[:1])[0]
        (got,) = svc.serve([SynthesisRequest(spec=specs[0])])
        assert svc.stats.fused_passes == 1
        assert_search_identical(got.result, ref)


class TestApplyProfile:
    def _workloads(self):
        from repro_torch.configs import smoke_config
        return {"qwen3-4b": C.gemm_inventory(smoke_config("qwen3-4b"))}

    def test_round_trip_persists_applied_weights(self, tmp_path):
        workloads = self._workloads()
        path = tmp_path / "profile.json"
        svc = service()
        sel, updated = apply_profile(
            path, lambda profile: select_macros(
                workloads, tech=TECH, resolution=RES,
                preference=(0.2, 0.6, 0.2), profile=profile, service=svc))
        assert updated.workloads["qwen3-4b"] == (0.2, 0.6, 0.2)
        assert load_preference_profile(path).weights_for("qwen3-4b") == \
            (0.2, 0.6, 0.2)
        sel2, _ = apply_profile(
            path, lambda profile: select_macros(
                workloads, tech=TECH, resolution=RES, profile=profile,
                service=svc))
        assert sel2.preferences_applied["qwen3-4b"] == (0.2, 0.6, 0.2)
        assert sel2.assignment == sel.assignment

    def test_none_path_runs_unprofiled(self):
        sel, updated = apply_profile(
            None, lambda profile: select_macros(
                self._workloads(), tech=TECH, resolution=RES,
                profile=profile, service=service()))
        assert updated is None
        assert sel.preferences_applied["qwen3-4b"] is None


# ---------------------------------------------------------------------------
# tests/test_registry.py, restated
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def one_result():
    return oracle(spec_variants(1, seed=97))[0]


class TestAtomicWriters:
    def test_no_fixed_temp_name(self, tmp_path):
        cache = FrontierCache(store_dir=tmp_path)
        cache.save_artifact("k", one_result())
        assert not (tmp_path / "k.tmp").exists()
        assert not list(tmp_path.glob("*.tmp"))
        assert not list(tmp_path.glob(".*.tmp"))

    def test_concurrent_same_key_writers_thread_hammer(self, tmp_path):
        cache = FrontierCache(store_dir=tmp_path)
        res = one_result()
        errors = []

        def writer():
            try:
                for _ in range(25):
                    cache.save_artifact("hot", res)
            except Exception as e:             # pragma: no cover
                errors.append(e)

        stop = threading.Event()

        def reader():
            path = tmp_path / "hot.json"
            try:
                while not stop.is_set():
                    if path.exists():
                        key, _ = load_artifact(path)
                        assert key == "hot"
            except Exception as e:             # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=writer) for _ in range(4)]
        rt = threading.Thread(target=reader)
        rt.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        rt.join()
        assert not errors
        assert not list(tmp_path.glob("*.tmp"))
        assert not list(tmp_path.glob(".*.tmp"))


class TestQuarantine:
    def test_rejected_artifact_quarantined_not_left_in_place(self, tmp_path):
        cache = FrontierCache(store_dir=tmp_path)
        cache.put("k", one_result())
        path = cache.artifact_path("k")
        path.write_text("not json {")
        fresh = FrontierCache(store_dir=tmp_path)
        assert fresh.get("k") is None
        assert fresh.stats.corrupt == 1
        assert not path.exists()
        assert path.with_suffix(".corrupt").exists()
        third = FrontierCache(store_dir=tmp_path)
        assert third.get("k") is None
        assert third.stats.corrupt == 0

    def test_registry_heals_poisoned_local_artifact(self, tmp_path):
        registry = ArtifactRegistry(tmp_path / "reg")
        cache = FrontierCache(store_dir=tmp_path / "local",
                              registry=registry)
        res = one_result()
        cache.put("k", res)
        cache.artifact_path("k").write_text("garbage")
        fresh = FrontierCache(store_dir=tmp_path / "local",
                              registry=ArtifactRegistry(tmp_path / "reg"))
        got = fresh.get("k")
        assert got is not None
        assert_search_identical(got, res)
        assert fresh.stats.corrupt == 1
        assert fresh.stats.shared_hits == 1
        key, healed = load_artifact(fresh.artifact_path("k"))
        assert key == "k"
        assert_search_identical(healed, res)

    def test_registry_quarantines_corrupt_shared_artifact(self, tmp_path):
        registry = ArtifactRegistry(tmp_path)
        registry.publish("k", one_result())
        registry.object_path("k").write_text("]]]")
        assert registry.fetch("k") is None
        assert registry.stats.corrupt == 1
        assert not registry.object_path("k").exists()
        assert registry.object_path("k").with_suffix(".corrupt").exists()
        assert registry.keys() == []


class TestStatsAccounting:
    @given(ops=st.lists(st.tuples(st.sampled_from(["get", "put", "corrupt"]),
                                  st.integers(min_value=0, max_value=5)),
                        max_size=40),
           capacity=st.integers(min_value=1, max_value=3),
           with_store=st.booleans(), with_registry=st.booleans())
    @settings(max_examples=20, deadline=None)
    def test_every_get_resolves_in_exactly_one_tier(self, ops, capacity,
                                                    with_store,
                                                    with_registry):
        res = one_result()
        with tempfile.TemporaryDirectory() as td:
            td = pathlib.Path(td)
            cache = FrontierCache(
                capacity=capacity,
                store_dir=td / "store" if with_store else None,
                registry=(ArtifactRegistry(td / "reg")
                          if with_registry else None))
            gets = 0
            for op, ki in ops:
                key = f"k{ki}"
                if op == "put":
                    cache.put(key, res)
                elif op == "get":
                    cache.get(key)
                    gets += 1
                elif op == "corrupt":
                    path = cache.artifact_path(key)
                    if path is not None and path.exists():
                        path.write_text("junk")
            s = cache.stats
            assert s.gets == gets
            assert s.gets == s.hits + s.disk_hits + s.shared_hits + s.misses
            assert len(cache) <= capacity
            if with_store:
                assert s.evictions_lost == 0
            if not with_store and not with_registry:
                assert s.evictions == 0

    def test_disk_hit_at_capacity_one_counts_once(self, tmp_path):
        res = one_result()
        cache = FrontierCache(capacity=1, store_dir=tmp_path)
        cache.put("a", res)
        cache.put("b", res)
        assert cache.get("a") is not None
        s = cache.stats
        assert (s.gets, s.hits, s.disk_hits, s.misses) == (1, 0, 1, 0)
        assert s.evictions == 2 and s.evictions_lost == 0


class TestRegistryProtocol:
    def test_publish_fetch_round_trip_bit_identical(self, tmp_path):
        registry = ArtifactRegistry(tmp_path)
        res = one_result()
        registry.publish("k", res, scope={"lattice": "d0"})
        got = ArtifactRegistry(tmp_path).fetch("k")
        assert_search_identical(got, res)
        assert registry.scope_of("k") == {"lattice": "d0"}
        assert registry.keys() == ["k"]

    def test_fetch_missing_is_counted_miss(self, tmp_path):
        registry = ArtifactRegistry(tmp_path)
        assert registry.fetch("nope") is None
        assert registry.stats.misses == 1

    def test_republish_is_noop(self, tmp_path):
        registry = ArtifactRegistry(tmp_path)
        registry.publish("k", one_result())
        registry.publish("k", one_result())
        assert registry.stats.fills == 1
        assert registry.stats.fill_noops == 1

    def test_claim_single_winner_release_reclaim(self, tmp_path):
        a = ArtifactRegistry(tmp_path)
        b = ArtifactRegistry(tmp_path)
        claim = a.claim("k")
        assert claim is not None
        assert b.claim("k") is None
        assert b.stats.claims_lost == 1
        claim.release()
        assert a.stats.claims_released == 1
        again = b.claim("k")
        assert again is not None
        again.release()

    def test_stale_claim_broken_after_ttl(self, tmp_path):
        holder = ArtifactRegistry(tmp_path, claim_ttl_s=0.05)
        holder.claim("k")
        time.sleep(0.08)
        taker = ArtifactRegistry(tmp_path, claim_ttl_s=0.05)
        claim = taker.claim("k")
        assert claim is not None
        assert taker.stats.claims_broken == 1
        claim.release()

    def test_wait_sees_concurrent_publish(self, tmp_path):
        registry = ArtifactRegistry(tmp_path)
        t = threading.Timer(0.05, registry.publish, ("k", one_result()))
        t.start()
        try:
            assert registry.wait("k", timeout_s=5.0)
        finally:
            t.join()
        assert registry.wait("missing", timeout_s=0.05) is False

    def test_invalidate_key_drops_artifact_and_meta(self, tmp_path):
        registry = ArtifactRegistry(tmp_path)
        registry.publish("k", one_result(), scope={"x": "d"})
        assert registry.invalidate_key("k")
        assert registry.keys() == []
        assert registry.scope_of("k") is None
        assert registry.stats.evictions == 1
        assert not registry.invalidate_key("k")

    def test_generic_payload_round_trip_and_schema_check(self, tmp_path):
        """The read and write the kernel autotuner makes through the
        registry (``publish_payload`` / ``fetch_payload``)."""
        registry = ArtifactRegistry(tmp_path)
        registry.publish_payload("t", {"tile": {"bm": 128}}, schema="s/v1")
        assert ArtifactRegistry(tmp_path).fetch_payload(
            "t", schema="s/v1") == {"tile": {"bm": 128}}
        other = ArtifactRegistry(tmp_path)
        assert other.fetch_payload("t", schema="other/v1") is None
        assert other.stats.corrupt == 1
        assert not registry.object_path("t").exists()


class TestThreeTierLookup:
    def test_registry_only_cache_round_trip(self, tmp_path):
        res = one_result()
        a = FrontierCache(registry=ArtifactRegistry(tmp_path))
        a.put("k", res)
        b = FrontierCache(registry=ArtifactRegistry(tmp_path))
        got = b.get("k")
        assert_search_identical(got, res)
        assert b.stats.shared_hits == 1
        assert b.get("k") is got
        assert b.stats.hits == 1

    def test_local_disk_preferred_over_registry(self, tmp_path):
        registry = ArtifactRegistry(tmp_path / "reg")
        a = FrontierCache(store_dir=tmp_path / "local", registry=registry)
        a.put("k", one_result())
        b = FrontierCache(store_dir=tmp_path / "local",
                          registry=ArtifactRegistry(tmp_path / "reg"))
        assert b.get("k") is not None
        assert b.stats.disk_hits == 1
        assert b.registry.stats.hits == 0

    def test_registry_hit_promoted_to_local_store(self, tmp_path):
        seed = FrontierCache(registry=ArtifactRegistry(tmp_path / "reg"))
        seed.put("k", one_result())
        b = FrontierCache(store_dir=tmp_path / "local",
                          registry=ArtifactRegistry(tmp_path / "reg"))
        assert b.get("k") is not None
        assert b.artifact_path("k").exists()
        c = FrontierCache(store_dir=tmp_path / "local")
        assert c.get("k") is not None
        assert c.stats.disk_hits == 1


class TestSharedServiceDrill:
    def test_second_service_full_shared_hits_zero_executions(
            self, tmp_path, execute_counter):
        specs = spec_variants(3, seed=61)
        reg_root = tmp_path / "registry"
        first = service(cache=FrontierCache(
            store_dir=tmp_path / "host-a",
            registry=ArtifactRegistry(reg_root)))
        cold = first.serve([SynthesisRequest(spec=s) for s in specs])
        assert first.stats.claims_acquired == len(specs)
        n_cold = len(execute_counter)
        assert n_cold >= 1
        second = service(cache=FrontierCache(
            store_dir=tmp_path / "host-b",
            registry=ArtifactRegistry(reg_root)))
        warm = second.serve([SynthesisRequest(spec=s) for s in specs])
        assert len(execute_counter) == n_cold
        assert second.stats.fused_passes == 0
        assert second.stats.misses == 0
        assert second.cache.stats.shared_hits == len(specs)
        for w, c in zip(warm, cold):
            assert w.served_from == "cache"
            assert_search_identical(w.result, c.result)

    def test_telemetry_rollup_sections(self, tmp_path):
        svc = service(cache=FrontierCache(registry=ArtifactRegistry(
            tmp_path)))
        svc.serve([SynthesisRequest(spec=spec_variants(1, seed=67)[0])])
        t = svc.telemetry()
        assert set(t) == {"service", "cache", "registry"}
        assert t["service"]["claims_acquired"] == 1
        assert t["cache"]["shared_hits"] == 0
        assert t["registry"]["fills"] == 1
        assert t["registry"]["entries"] == 1

    def test_claim_wait_serves_peer_publish(self, tmp_path):
        spec = spec_variants(1, seed=71)[0]
        registry = ArtifactRegistry(tmp_path)
        svc = service(claim_wait_s=30.0, cache=FrontierCache(
            registry=ArtifactRegistry(tmp_path)))
        key = svc.key_for(SynthesisRequest(spec=spec))
        peer_claim = registry.claim(key)
        ref = oracle([spec])[0]

        def peer_publishes():
            registry.publish(key, ref)
            peer_claim.release()

        t = threading.Timer(0.1, peer_publishes)
        t.start()
        try:
            (resp,) = svc.serve([SynthesisRequest(spec=spec)])
        finally:
            t.join()
        assert resp.served_from == "cache"
        assert svc.stats.claim_waits == 1
        assert svc.stats.claim_hits == 1
        assert svc.stats.fused_passes == 0
        assert_search_identical(resp.result, ref)

    def test_claim_wait_timeout_synthesizes_anyway(self, tmp_path):
        spec = spec_variants(1, seed=73)[0]
        registry = ArtifactRegistry(tmp_path)
        svc = service(claim_wait_s=0.05, cache=FrontierCache(
            registry=ArtifactRegistry(tmp_path)))
        registry.claim(svc.key_for(SynthesisRequest(spec=spec)))
        (resp,) = svc.serve([SynthesisRequest(spec=spec)])
        assert resp.served_from == "engine"
        assert svc.stats.claim_waits == 1
        assert svc.stats.claim_timeouts == 1
        assert_search_identical(resp.result, oracle([spec])[0])


class TestScopedInvalidation:
    CFG = LatticeConfig(memcells=(sc.MemCellKind.SRAM_6T,
                                  sc.MemCellKind.DLATCH_8T))

    def _sweep(self, tech, store, reg_root):
        svc = SynthesisService(
            tech=tech, config=self.CFG, device=CPU,
            cache=FrontierCache(store_dir=store,
                                registry=(None if reg_root is None else
                                          ArtifactRegistry(reg_root))))
        (resp,) = svc.serve([SynthesisRequest(spec=MacroSpec(), tech=tech,
                                              kind="sweep")])
        return svc, resp

    def test_recalibration_evicts_exactly_the_stale_entries(self, tmp_path):
        reg_root = tmp_path / "registry"
        self._sweep(TECH, tmp_path / "host-a", reg_root)
        registry = ArtifactRegistry(reg_root)
        all_keys = set(registry.keys())
        n_slices = (len(self.CFG.memcells) + len(self.CFG.multmuxes)
                    + len(self.CFG.rho_steps) + len(self.CFG.pipe_steps))
        assert len(all_keys) == 1 + n_slices
        bumped = dataclasses.replace(TECH, a_sram8t=TECH.a_sram8t * 1.05)
        evicted = set(registry.invalidate_digests(
            stale_digests(TECH, bumped, self.CFG)))
        survivors = set(registry.keys())
        assert evicted | survivors == all_keys and not (evicted & survivors)
        warm_6t = slice_key(MacroSpec(), TECH, "memcell", 0, config=self.CFG)
        assert survivors == {warm_6t}
        assert slice_key(MacroSpec(), bumped, "memcell", 0,
                         config=self.CFG) == warm_6t
        assert registry.stats.evictions == len(evicted)

    def test_fleetwide_incremental_resweep_after_invalidation(self,
                                                              tmp_path):
        reg_root = tmp_path / "registry"
        self._sweep(TECH, tmp_path / "a", reg_root)
        bumped = dataclasses.replace(TECH, a_sram8t=TECH.a_sram8t * 1.05)
        ArtifactRegistry(reg_root).invalidate_digests(
            stale_digests(TECH, bumped, self.CFG))
        host_b, warm = self._sweep(bumped, tmp_path / "b", reg_root)
        assert host_b.stats.incremental_passes == 1
        assert host_b.stats.slice_hits == 1
        assert host_b.cache.stats.shared_hits >= 1
        cold_svc, cold = self._sweep(bumped, tmp_path / "c", None)
        assert cold_svc.stats.incremental_passes == 0
        assert dataclasses.asdict(warm.result) == \
            dataclasses.asdict(cold.result)

    def test_scope_records_published_for_search_and_slices(self, tmp_path):
        svc = service(cache=FrontierCache(registry=ArtifactRegistry(
            tmp_path)))
        req = SynthesisRequest(spec=spec_variants(1, seed=79)[0])
        svc.serve([req])
        registry = ArtifactRegistry(tmp_path)
        (key,) = registry.keys()
        assert key == svc.key_for(req)
        scope = registry.scope_of(key)
        assert scope == key_scope(TECH, seed_config(svc.memcells))
        assert "lattice" in scope and "__global__" in scope


def _run_workers(codes_and_args, timeout=300):
    """One subprocess per (code, argv), all at once; each must exit 0."""
    env = {**_env(), "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, "-c", code, *map(str, argv)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO)
             for code, argv in codes_and_args]
    done = [p.communicate(timeout=timeout) for p in procs]
    for p, (out, err) in zip(procs, done):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    return [out for out, _ in done]


_WRITER_CODE = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    from repro_torch.service import ArtifactRegistry, FrontierCache
    from repro_torch.service.artifacts import result_from_payload

    payloads_path, store, reg_root, worker, iters = sys.argv[1:6]
    payloads = json.loads(Path(payloads_path).read_text())
    results = {k: result_from_payload(p) for k, p in payloads.items()}
    cache = FrontierCache(store_dir=store,
                          registry=ArtifactRegistry(reg_root))
    order = sorted(results)
    if int(worker) % 2:
        order = order[::-1]
    for _ in range(int(iters)):
        for k in order:
            cache.put(k, results[k])
    readback = FrontierCache(store_dir=store,
                             registry=ArtifactRegistry(reg_root))
    ok = all(readback.get(k) is not None for k in results)
    print(json.dumps({"ok": ok, "corrupt": readback.stats.corrupt}))
""")


class TestMultiProcessStress:
    N_WORKERS = 3
    ITERS = 20

    def test_concurrent_writers_same_and_different_keys(self, tmp_path):
        specs = spec_variants(2, seed=83)
        results = oracle(specs)
        svc = service()
        shared_keys = [svc.key_for(SynthesisRequest(spec=s)) for s in specs]
        store, reg_root = tmp_path / "store", tmp_path / "registry"
        workers = []
        for w in range(self.N_WORKERS):
            payloads = {k: result_to_payload(r)
                        for k, r in zip(shared_keys, results)}
            payloads[f"{shared_keys[0]}-w{w}"] = result_to_payload(
                results[0])
            ppath = tmp_path / f"payloads-{w}.json"
            ppath.write_text(json.dumps(payloads))
            workers.append((_WRITER_CODE,
                            [ppath, store, reg_root, w, self.ITERS]))
        for out in _run_workers(workers):
            assert json.loads(out.strip().splitlines()[-1]) == \
                {"ok": True, "corrupt": 0}
        for d in (store, reg_root / "objects"):
            assert not list(d.glob("*.tmp")) and not list(d.glob(".*.tmp"))
        final = FrontierCache(store_dir=store,
                              registry=ArtifactRegistry(reg_root))
        for k, ref in zip(shared_keys, results):
            got = final.get(k)
            assert got is not None
            assert_search_identical(got, ref)
        for w in range(self.N_WORKERS):
            assert final.get(f"{shared_keys[0]}-w{w}") is not None
        assert final.stats.corrupt == 0
        assert len(ArtifactRegistry(reg_root).keys()) == \
            len(shared_keys) + self.N_WORKERS


_CLAIM_CODE = textwrap.dedent("""
    import json, sys, time
    from pathlib import Path
    from repro_torch.service import ArtifactRegistry

    reg_root, gate_dir, worker = sys.argv[1:4]
    registry = ArtifactRegistry(reg_root)
    gate = Path(gate_dir)
    (gate / f"ready-{worker}").touch()
    while not (gate / "go").exists():
        time.sleep(0.002)
    claim = registry.claim("contended")
    print(json.dumps({"acquired": claim is not None}))
""")


class TestClaimContention:
    N_WORKERS = 4

    def test_exactly_one_cross_process_claim_winner(self, tmp_path):
        gate = tmp_path / "gate"
        gate.mkdir()
        env = {**_env(), "CUDA_VISIBLE_DEVICES": ""}
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CLAIM_CODE,
             str(tmp_path / "registry"), str(gate), str(w)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO) for w in range(self.N_WORKERS)]
        deadline = time.monotonic() + 240
        while (len(list(gate.glob("ready-*"))) < self.N_WORKERS
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert len(list(gate.glob("ready-*"))) == self.N_WORKERS
        (gate / "go").touch()
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"claimer failed:\n{err[-2000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        assert sum(1 for o in outs if o["acquired"]) == 1


_SERVICE_CODE = textwrap.dedent("""
    import json, sys
    from repro_torch.core import engine
    from repro_torch.core.multispec import scenario_specs
    from repro_torch.service import (ArtifactRegistry, FrontierCache,
                                     SynthesisRequest, SynthesisService)
    from repro_torch.service.artifacts import result_to_payload

    reg_root, local_store, out_path = sys.argv[1:4]
    calls = []
    engine.add_execute_hook(calls.append)
    svc = SynthesisService(
        resolution=3, device="cpu",
        cache=FrontierCache(store_dir=local_store,
                            registry=ArtifactRegistry(reg_root)))
    specs = list(scenario_specs().values())[:3]
    responses = svc.serve([SynthesisRequest(spec=s) for s in specs])
    json.dump({"executes": len(calls),
               "service": svc.stats.as_dict(),
               "cache": svc.cache.stats.as_dict(),
               "results": [result_to_payload(r.result)
                           for r in responses]}, open(out_path, "w"))
""")


class TestTwoProcessDrill:
    def test_second_process_zero_executions_bit_identical(self, tmp_path):
        reg_root = tmp_path / "registry"
        out_a, out_b = tmp_path / "a.json", tmp_path / "b.json"
        _run_workers([(_SERVICE_CODE, [reg_root, tmp_path / "host-a",
                                       out_a])])
        _run_workers([(_SERVICE_CODE, [reg_root, tmp_path / "host-b",
                                       out_b])])
        a = json.loads(out_a.read_text())
        b = json.loads(out_b.read_text())
        assert a["executes"] >= 1
        assert a["service"]["claims_acquired"] == 3
        assert b["executes"] == 0
        assert b["service"]["fused_passes"] == 0
        assert b["service"]["misses"] == 0
        assert b["cache"]["shared_hits"] == 3
        assert a["results"] == b["results"]


# ---------------------------------------------------------------------------
# tests/test_frontend.py, restated
# ---------------------------------------------------------------------------


class TestTypedRequestAPI:
    def test_serve_bit_identical_to_oracle(self, execute_counter):
        specs = spec_variants(4, seed=61)
        ref = oracle(specs)
        svc = service()
        n0 = len(execute_counter)
        responses = svc.serve([SynthesisRequest(spec=s) for s in specs])
        assert len(execute_counter) == n0 + 1
        for r, o in zip(responses, ref):
            assert isinstance(r, SynthesisResponse)
            assert r.state is RequestState.SERVED
            assert r.served_from == "engine"
            assert_search_identical(r.result, o)

    def test_served_from_tiers(self):
        specs = spec_variants(2, seed=67)
        svc = service()
        first = svc.serve([SynthesisRequest(spec=specs[0]),
                           SynthesisRequest(spec=specs[1]),
                           SynthesisRequest(spec=specs[0])])
        assert [r.served_from for r in first] == \
            ["engine", "engine", "coalesced"]
        assert first[2].result is first[0].result
        again = svc.serve([SynthesisRequest(spec=specs[0])])
        assert again[0].served_from == "cache"
        assert again[0].result is first[0].result

    def test_per_request_resolution_and_tech(self):
        spec = spec_variants(1, seed=71)[0]
        svc = service()
        (r5,) = svc.serve([SynthesisRequest(spec=spec, resolution=5)])
        (oracle5,) = oracle([spec], resolution=5)
        assert_search_identical(r5.result, oracle5)
        r3, r5b = svc.serve([SynthesisRequest(spec=spec, resolution=3),
                             SynthesisRequest(spec=spec, resolution=5)])
        assert_search_identical(r3.result, oracle([spec])[0])
        assert_search_identical(r5b.result, oracle5)

    def test_mixed_tech_requests_fuse_into_one_pass(self, execute_counter):
        specs = spec_variants(2, seed=73)
        slow = dataclasses.replace(TECH, tau_ps=TECH.tau_ps * 1.25)
        oracle_a = oracle(specs[:1])[0]
        oracle_b = oracle(specs[1:], tech=slow)[0]
        svc = service()
        n0 = len(execute_counter)
        ra, rb = svc.serve([SynthesisRequest(spec=specs[0]),
                            SynthesisRequest(spec=specs[1], tech=slow)])
        assert len(execute_counter) == n0 + 1
        assert_search_identical(ra.result, oracle_a)
        assert_search_identical(rb.result, oracle_b)

    def test_on_partial_streams_every_request(self):
        specs = spec_variants(3, seed=79)
        stream = [specs[0], specs[1], specs[0], specs[2]]
        svc = service()
        events = []
        responses = svc.serve([SynthesisRequest(spec=s) for s in stream],
                              on_partial=lambda i, r: events.append(i))
        assert sorted(events) == [0, 1, 2, 3]
        assert all(responses[i].result is not None for i in events)
        assert responses[2].result is responses[0].result

    def test_rejects_bare_specs_and_bad_requests(self):
        spec = spec_variants(1, seed=83)[0]
        svc = service()
        with pytest.raises(TypeError):
            svc.serve([spec])
        with pytest.raises(TypeError):
            SynthesisRequest(spec="not a spec")
        with pytest.raises(ValueError):
            SynthesisRequest(spec=spec, deadline_s=0.0)
        with pytest.raises(ValueError):
            svc.serve([SynthesisRequest(spec=spec, mode="warp-drive")])


class TestDeprecationShims:
    def test_shims_warn_and_match_typed_api(self):
        specs = spec_variants(3, seed=89)
        ref = [r.result for r in
               service().serve([SynthesisRequest(spec=s) for s in specs])]
        legacy = service()
        with pytest.deprecated_call():
            one = legacy.synthesize(specs[0])
        with pytest.deprecated_call():
            many = legacy.synthesize_many(specs)
        assert_search_identical(one, ref[0])
        for g, r in zip(many, ref):
            assert_search_identical(g, r)

    def test_request_key_shim_matches_key_for(self):
        spec = spec_variants(1, seed=97)[0]
        svc = service()
        with pytest.deprecated_call():
            old = svc.request_key(spec, resolution=5)
        assert old == svc.key_for(SynthesisRequest(spec=spec, resolution=5))
        svc.serve([SynthesisRequest(spec=spec, resolution=5)])
        assert svc.cache.get(old) is not None


def make_front(**kw):
    kw.setdefault("start", False)
    return ServiceFrontend(service(), **kw)


class TestLifecycle:
    def test_queued_batched_served_transitions(self):
        front = make_front()
        try:
            spec = spec_variants(1, seed=101)[0]
            events = []
            t = front.submit(SynthesisRequest(spec=spec),
                             on_event=lambda e: events.append(e.kind))
            assert t.state is RequestState.QUEUED and not t.done()
            assert front.depth == 1
            assert front.run_pending() == 1 and front.depth == 0
            resp = t.result(timeout=0)
            assert t.state is RequestState.SERVED
            assert [k for k in events if k != FRONTIER_EVENT] == \
                ["queued", "batched", "served"]
            assert FRONTIER_EVENT in events
            assert resp.queued_at <= resp.batched_at <= resp.served_at
            assert resp.latency_s >= 0 and resp.queue_delay_s >= 0
            assert_search_identical(resp.result, oracle([spec])[0])
        finally:
            front.close()

    def test_deadline_expired_request_is_shedded(self):
        front = make_front()
        try:
            t = front.submit(SynthesisRequest(
                spec=spec_variants(1, seed=103)[0], deadline_s=1e-6))
            time.sleep(0.01)
            front.run_pending()
            resp = t.result(timeout=0)
            assert isinstance(resp, SheddedResponse)
            assert resp.reason == "deadline"
            assert resp.state is RequestState.SHEDDED
            assert front.stats.shedded == 1 and front.stats.served == 0
        finally:
            front.close()

    def test_result_timeout_raises(self):
        front = make_front()
        try:
            t = front.submit(SynthesisRequest(
                spec=spec_variants(1, seed=107)[0]))
            with pytest.raises(TimeoutError):
                t.result(timeout=0.01)
        finally:
            front.close()


class TestPriorityOrdering:
    def test_interactive_ahead_of_bulk_fifo_within_class(self):
        front = make_front(max_batch=16)
        try:
            specs = spec_variants(5, seed=109)
            order = []

            def watch(tag):
                return lambda e: (order.append(tag)
                                  if e.kind == "batched" else None)

            for spec, tag, prio in zip(
                    specs, ["b0", "b1", "i0", "i1", "b2"],
                    [Priority.BULK, Priority.BULK, Priority.INTERACTIVE,
                     Priority.INTERACTIVE, Priority.BULK]):
                front.submit(SynthesisRequest(spec=spec, tag=tag,
                                              priority=prio),
                             on_event=watch(tag))
            front.run_pending()
            assert order == ["i0", "i1", "b0", "b1", "b2"]
        finally:
            front.close()


class TestBackpressure:
    def test_bounded_depth_sheds_typed_never_silent(self):
        front = make_front(max_depth=3)
        try:
            specs = spec_variants(5, seed=113)
            tickets = [front.submit(SynthesisRequest(spec=s)) for s in specs]
            assert front.stats.depth_hwm == 3
            shed = [t for t in tickets if t.done()]
            assert len(shed) == 2
            for t in shed:
                resp = t.result(timeout=0)
                assert isinstance(resp, SheddedResponse)
                assert resp.reason == "queue_full"
                assert resp.queue_depth == 3
            assert front.stats.shedded == 2
            front.run_pending()
            for t, o in zip(tickets[:3], oracle(specs[:3])):
                assert_search_identical(t.result(timeout=0).result, o)
        finally:
            front.close()

    def test_close_without_drain_sheds_shutdown(self):
        front = make_front()
        spec = spec_variants(1, seed=127)[0]
        t = front.submit(SynthesisRequest(spec=spec))
        front.close(drain=False)
        resp = t.result(timeout=0)
        assert isinstance(resp, SheddedResponse)
        assert resp.reason == "shutdown"
        t2 = front.submit(SynthesisRequest(spec=spec))
        assert t2.result(timeout=0).reason == "shutdown"


class TestStreaming:
    def test_sweep_streams_frontier_so_far(self):
        front = make_front(max_batch=2)
        try:
            specs = spec_variants(5, seed=131)
            seen = []
            handle = front.submit_sweep(
                specs, on_frontier=lambda done, total, pool:
                seen.append((done, total, len(pool))))
            while front.run_pending():
                pass
            responses = handle.results(timeout=0)
            assert [r.state for r in responses] == \
                [RequestState.SERVED] * len(specs)
            assert [d for d, _, _ in seen] == list(range(1, len(specs) + 1))
            assert all(t == len(specs) for _, t, _ in seen)
            ref_pool, _ = frontier_union(
                oracle(specs), [f"sweep[{i}]" for i in range(len(specs))])
            assert seen[-1][2] == len(ref_pool)
        finally:
            front.close()


class TestThreadedFrontend:
    def test_burst_served_bit_identical(self):
        specs = spec_variants(4, seed=137)
        stream = [specs[i % 4] for i in range(10)]
        ref = oracle(specs)
        svc = service()
        with ServiceFrontend(svc, window=0.02, max_batch=16) as front:
            tickets = [front.submit(SynthesisRequest(spec=s))
                       for s in stream]
            responses = [t.result(timeout=300) for t in tickets]
        assert front.stats.served == len(stream)
        assert front.stats.shedded == 0
        assert svc.stats.fused_passes >= 1
        for resp, spec in zip(responses, stream):
            assert_search_identical(resp.result, ref[specs.index(spec)])

    def test_frontend_serve_helper_and_select_macros(self):
        from repro_torch.configs import smoke_config
        workloads = {"qwen3-4b": C.gemm_inventory(smoke_config("qwen3-4b"))}
        direct = select_macros(workloads, tech=TECH, resolution=RES,
                               service=service())
        with ServiceFrontend(service()) as front:
            routed = select_macros(workloads, tech=TECH, resolution=RES,
                                   service=front)
        assert routed.assignment == direct.assignment
        assert routed.pool_labels == direct.pool_labels
        assert routed.summary() == direct.summary()

    def test_adaptive_window_tracks_engine_latency(self):
        front = make_front(window=0.005)
        try:
            assert front.effective_window() == 0.005
            front._observe_pass(None, 1.0)
            w1 = front.effective_window()
            assert WINDOW_BOUNDS[0] <= w1 <= WINDOW_BOUNDS[1]
            assert w1 > 0.005
            front._observe_pass(None, 100.0)
            assert front.effective_window() == WINDOW_BOUNDS[1]
        finally:
            front.close()

    def test_engine_latency_hook_fires_with_elapsed(self):
        seen = []
        hook = lambda plan, s: seen.append((plan, s))
        engine.add_latency_hook(hook)
        try:
            service().serve([SynthesisRequest(
                spec=spec_variants(1, seed=139)[0])])
        finally:
            engine.remove_latency_hook(hook)
        assert len(seen) == 1
        plan, elapsed = seen[0]
        assert elapsed > 0 and len(plan) == 1


def _args(**kw):
    base = dict(dcim_config=None, dcim_select=False, dcim_pref=None,
                dcim_profile=None, dcim_cache=None, dcim_macros=None)
    base.update(kw)
    return Namespace(**base)


class TestServeConfig:
    def test_round_trip(self, tmp_path):
        cfg = ServeConfig(select=True, pref=(0.2, 0.6, 0.2),
                          profile="p.json", cache="frontiers", macros=128)
        path = tmp_path / "serve.json"
        save_serve_config(path, cfg)
        assert json.loads(path.read_text())["schema"] == SERVE_CONFIG_SCHEMA
        assert load_serve_config(path) == cfg

    def test_unknown_key_and_bad_schema_rejected(self, tmp_path):
        path = tmp_path / "serve.json"
        path.write_text(json.dumps({"schema": SERVE_CONFIG_SCHEMA,
                                    "selekt": True}))
        with pytest.raises(ValueError, match="unknown serve-config keys"):
            load_serve_config(path)
        path.write_text(json.dumps({"schema": "other/v1"}))
        with pytest.raises(ValueError, match="not a serve config"):
            load_serve_config(path)

    def test_defaults_without_config(self):
        assert serve_config_from_args(_args()) == ServeConfig()
        got = serve_config_from_args(_args(dcim_select=True,
                                           dcim_pref="1,0,0"))
        assert got.select and got.pref == (1.0, 0.0, 0.0)
        assert got.macros == 256

    def test_cli_flags_override_file(self, tmp_path):
        path = tmp_path / "serve.json"
        save_serve_config(path, ServeConfig(select=True,
                                            pref=(0.2, 0.6, 0.2),
                                            cache="from-file", macros=64))
        got = serve_config_from_args(_args(dcim_config=str(path)))
        assert got == ServeConfig(select=True, pref=(0.2, 0.6, 0.2),
                                  cache="from-file", macros=64)
        got = serve_config_from_args(_args(dcim_config=str(path),
                                           dcim_pref="1,0,0",
                                           dcim_macros=512))
        assert got.pref == (1.0, 0.0, 0.0) and got.macros == 512
        assert got.select and got.cache == "from-file"

    def test_parse_pref_validates(self):
        with pytest.raises(ValueError):
            parse_pref("0.5,0.5")
        with pytest.raises(ValueError):
            ServeConfig(pref=(1.0, 2.0))
        with pytest.raises(ValueError):
            ServeConfig(macros=0)


class TestSingletonThreadSafety:
    def _grab_concurrently(self, n=16):
        barrier = threading.Barrier(n)
        seen, errors = [], []
        lock = threading.Lock()

        def grab():
            barrier.wait()
            try:
                svc = get_service()
            except RuntimeError as e:
                with lock:
                    errors.append(e)
                return
            with lock:
                seen.append(id(svc))

        threads = [threading.Thread(target=grab) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return seen, errors

    def test_concurrent_get_service_one_instance(self, monkeypatch):
        """Sixteen threads racing the first ``get_service()`` build one
        service (built here on the CPU in place of the card)."""
        reset_service()
        monkeypatch.setattr(service_mod, "resolve_device",
                            lambda device=None: torch.device(CPU))
        try:
            seen, errors = self._grab_concurrently()
            assert not errors
            assert len(seen) == 16 and len(set(seen)) == 1
            assert get_service().device == torch.device(CPU)
        finally:
            reset_service()

    def test_concurrent_get_service_without_card_all_raise(self,
                                                           monkeypatch):
        reset_service()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        try:
            seen, errors = self._grab_concurrently()
            assert seen == [] and len(errors) == 16
            assert service_mod._DEFAULT_SERVICE is None
        finally:
            reset_service()


# ---------------------------------------------------------------------------
# tests/test_obs.py's service and frontend span checks, restated
# ---------------------------------------------------------------------------


@pytest.fixture
def traced():
    configure(enabled=True, sample=1.0)
    tracer.clear()
    yield tracer
    tracer.configure(enabled=False)
    tracer.clear()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


class TestTelemetryCompat:
    def test_service_stats_keys(self):
        assert tuple(ServiceStats().as_dict()) == (
            "requests", "cache_hits", "coalesced", "misses", "fused_passes",
            "slice_hits", "incremental_passes", "claims_acquired",
            "claim_waits", "claim_hits", "claim_timeouts")

    def test_cache_stats_keys(self):
        assert tuple(CacheStats().as_dict()) == (
            "gets", "hits", "disk_hits", "shared_hits", "misses", "puts",
            "evictions", "evictions_lost", "corrupt")

    def test_registry_stats_keys(self):
        assert tuple(RegistryStats().as_dict()) == (
            "hits", "misses", "fills", "fill_noops", "corrupt",
            "claims_acquired", "claims_lost", "claims_broken",
            "claims_released", "evictions")

    def test_frontend_stats_keys(self):
        assert tuple(FrontendStats().as_dict()) == (
            "submitted", "served", "shedded", "batches", "max_batch",
            "depth_hwm")

    def test_registry_telemetry_adds_entries(self, tmp_path):
        t = ArtifactRegistry(tmp_path).telemetry()
        assert set(t) == set(RegistryStats().as_dict()) | {"entries"}

    def test_service_telemetry_sections(self, tmp_path):
        assert set(service().telemetry()) == {"service", "cache"}
        svc = service(cache=FrontierCache(registry=ArtifactRegistry(
            tmp_path)))
        assert set(svc.telemetry()) == {"service", "cache", "registry"}


class TestServiceSpans:
    def _serve(self, svc, specs):
        roots = [tracer.start_trace("request") for _ in specs]
        responses = svc.serve([SynthesisRequest(spec=s) for s in specs],
                              contexts=[r.context for r in roots])
        for r in roots:
            r.finish()
        return responses

    def test_mem_only_cache_probes_one_tier(self, traced):
        self._serve(service(), spec_variants(2, seed=21))
        spans = tracer.drain()
        assert len(_by_name(spans, "cache.mem")) == 2
        for tier in ("cache.disk", "cache.registry", "cache.claim"):
            assert not _by_name(spans, tier)
        assert all(s.tags["outcome"] == "miss"
                   for s in _by_name(spans, "cache.mem"))

    def test_all_tiers_probed_when_configured(self, traced, tmp_path):
        svc = service(cache=FrontierCache(
            store_dir=tmp_path / "store",
            registry=ArtifactRegistry(tmp_path / "reg")))
        (spec,) = spec_variants(1, seed=22)
        self._serve(svc, [spec])
        spans = tracer.drain()
        for tier in ("cache.mem", "cache.disk", "cache.registry"):
            (s,) = _by_name(spans, tier)
            assert s.tags["outcome"] == "miss"
        (claim,) = _by_name(spans, "cache.claim")
        assert claim.tags["outcome"] == "acquired"
        self._serve(svc, [spec])
        spans = tracer.drain()
        (mem,) = _by_name(spans, "cache.mem")
        assert mem.tags["outcome"] == "hit"
        assert not _by_name(spans, "cache.disk")
        assert not _by_name(spans, "cache.registry")

    def test_shared_engine_pass_cross_links(self, traced):
        specs = spec_variants(2, seed=23)
        self._serve(service(), [specs[0], specs[1], specs[0]])
        spans = tracer.drain()
        (engine_pass,) = _by_name(spans, "engine.pass")
        assert engine_pass.tags["n_requests"] == 2
        links = _by_name(spans, "request.engine")
        assert len(links) == 3
        assert {l.tags["engine_pass"] for l in links} == \
            {engine_pass.span_id}
        assert {l.tags["engine_trace"] for l in links} == \
            {engine_pass.trace_id}
        assert sorted(l.tags["coalesced"] for l in links) == \
            [False, False, True]
        assert all(l.trace_id != engine_pass.trace_id for l in links)
        for phase in ("engine.plan", "engine.place", "engine.execute"):
            (p,) = _by_name(spans, phase)
            assert p.trace_id == engine_pass.trace_id
        assert len(_by_name(spans, "engine.extract")) == 2
        assert _by_name(spans, "engine.execute")[0].tags["n_specs"] == 2
        place = _by_name(spans, "engine.place")[0]
        assert place.tags["mode"] == "vmap" and place.tags["n_dev"] >= 1

    def test_untraced_serve_records_nothing(self, traced):
        service().serve([SynthesisRequest(spec=spec_variants(1, 24)[0])])
        spans = tracer.drain()
        assert not _by_name(spans, "cache.mem")
        assert len(_by_name(spans, "engine.pass")) == 1

    def test_tracing_off_records_nothing_at_all(self):
        assert not tracer.enabled
        service().serve([SynthesisRequest(spec=spec_variants(1, 25)[0])])
        assert tracer.spans() == []

    def test_six_n_plus_four_census(self, traced):
        """N requests through the frontend, one fused pass: N request
        roots with their queued / batched / mem-tier / engine-link
        children and one extract each (6N), plus the pass, plan, place and
        execute spans (4)."""
        specs = spec_variants(4, seed=26)
        with ServiceFrontend(service(), window=0.05, max_batch=8) as front:
            front.serve([SynthesisRequest(spec=s) for s in specs],
                        timeout=300)
        spans = tracer.drain()
        assert len(_by_name(spans, "engine.pass")) == 1
        assert len(spans) == 6 * len(specs) + 4


class TestFrontendSpans:
    def test_span_boundaries_equal_response_timestamps(self, traced):
        from repro_torch.obs.metrics import get_registry
        specs = spec_variants(3, seed=31)
        with ServiceFrontend(service(), window=0.02, max_batch=8) as front:
            tickets = [front.submit(SynthesisRequest(spec=s)) for s in specs]
            responses = [t.result(timeout=300) for t in tickets]
        spans = tracer.drain()
        roots = _by_name(spans, "request")
        assert len(roots) == 3
        for resp in responses:
            root = next(s for s in roots if s.start_s == resp.queued_at)
            assert root.end_s == resp.served_at
            assert root.tags["served_from"] == resp.served_from
            queued = next(s for s in _by_name(spans, "request.queued")
                          if s.parent_id == root.span_id)
            batched = next(s for s in _by_name(spans, "request.batched")
                           if s.parent_id == root.span_id)
            assert queued.start_s == resp.queued_at
            assert queued.end_s == resp.batched_at
            assert batched.start_s == resp.batched_at
            assert batched.end_s == resp.served_at
            assert batched.tags["batch_size"] >= 1
        assert get_registry().histogram(
            "frontend/request_latency_s").count >= 3

    def test_shed_finishes_span_with_reason(self, traced):
        front = ServiceFrontend(service(), max_depth=1, start=False)
        specs = spec_variants(3, seed=32)
        front.submit(SynthesisRequest(spec=specs[0]))
        t2 = front.submit(SynthesisRequest(spec=specs[1]))
        assert t2.done()
        shed = next(s for s in tracer.spans() if s.name == "request"
                    and "shedded" in s.tags)
        assert shed.tags["shedded"] == "queue_full"
        front.close(drain=False)


# ---------------------------------------------------------------------------
# scripts/torch_warm_cache.py and the autotuner's registry
# ---------------------------------------------------------------------------


class TestWarmCacheScript:
    def _run(self, *args):
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "torch_warm_cache.py"),
             "--device", CPU, *map(str, args)],
            env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
            text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    def test_warm_then_served_with_zero_passes(self, tmp_path,
                                               execute_counter):
        store, reg = tmp_path / "store", tmp_path / "registry"
        first = self._run("--store", store, "--registry", reg,
                          "--resolutions", "2,3", "--scenarios",
                          "vision,cloud")
        assert "4 synthesized, 0 already warm" in first
        again = self._run("--store", store, "--resolutions", "2,3",
                          "--scenarios", "vision,cloud")
        assert "0 synthesized, 4 already warm" in again
        svc = service(cache=FrontierCache(registry=ArtifactRegistry(reg)))
        specs = C.scenario_specs()
        resp = svc.serve([SynthesisRequest(spec=specs[n], resolution=r)
                          for n in ("vision", "cloud") for r in (2, 3)])
        assert execute_counter == []
        assert svc.cache.stats.shared_hits == 4
        for r in resp:
            assert_search_identical(
                r.result, oracle([r.request.spec], r.request.resolution)[0])

    def test_rejects_autotune_without_registry(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "torch_warm_cache.py"),
             "--device", CPU, "--store", str(tmp_path),
             "--autotune-kernels", "default"],
            env=_env(), capture_output=True, text=True, timeout=300)
        assert proc.returncode == 2
        assert "pass --registry" in proc.stderr

    def test_autotune_kernels_resolve_auto_tiles_from_registry(self,
                                                               tmp_path):
        """The registry the script fills is what ``tile_config="auto"``
        reads in a cold process (here the plain versions' tunings, keyed
        to the CPU)."""
        from repro_torch.kernels import autotune
        from repro_torch.kernels.csa_tree import csa_tree_ref, csa_tree_sum
        from repro_torch.kernels.dcim_mac import dcim_matmul
        from repro_torch.kernels.dcim_mac.ref import dcim_matmul_ref
        from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
        from repro_torch.obs.metrics import get_registry

        reg = tmp_path / "registry"
        out = self._run("--registry", reg, "--resolutions", "2",
                        "--scenarios", "vision", "--autotune-kernels",
                        "dcim_mac:32x128x128,csa_tree:64x256,"
                        "ssm_scan:128x128", "--autotune-iters", "1")
        assert "3 tile artifacts" in out
        g = torch.Generator().manual_seed(0)
        a = torch.randint(-128, 128, (32, 128), generator=g,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (128, 128), generator=g,
                          dtype=torch.int8)
        a_s, w_s = torch.rand(32, generator=g), torch.rand(128, generator=g)
        x = torch.randint(-999, 999, (64, 256), generator=g,
                          dtype=torch.int32)
        sa = torch.rand((128, 128), generator=g) * 0.3 + 0.7
        sb, h0 = torch.randn((128, 128), generator=g), torch.randn(128)
        calls = {
            "dcim_mac": (lambda: dcim_matmul(a, w, a_s, w_s,
                                             tile_config="auto"),
                         lambda: dcim_matmul_ref(a, w, a_s, w_s)),
            "csa_tree": (lambda: csa_tree_sum(x, tile_config="auto"),
                         lambda: csa_tree_ref(x)),
            "ssm_scan": (lambda: ssm_scan(sa, sb, h0, tile_config="auto")[0],
                         lambda: ssm_scan_ref(sa, sb, h0)[0]),
        }
        autotune.clear_memo()
        autotune.set_registry(ArtifactRegistry(reg))
        try:
            for kernel, (run, plain) in calls.items():
                counter = get_registry().counter(
                    f"kernel/{kernel}/tile_source/registry")
                before = counter.value
                assert torch.equal(run(), plain())
                assert counter.value == before + 1, kernel
        finally:
            autotune.set_registry(None)
            autotune.clear_memo()
