"""The port's dry-run accounting (``launch/dryrun.py``, ``launch/tuned.py``,
``roofline/{op_cost,report,reanalyze}.py``) against the JAX package's, on
the CPU.

* ``model_flops_per_step`` and ``skip_table`` equal the reference's for
  every arch and shape, ``tuned_overrides`` for every (arch, shape, mesh)
  key with the wildcards.
* ``op_cost`` counts an 8-step chain of (64, 256) x (256, 256) matmuls as
  2·M·N·K x 8, and the ring bytes of all-reduce, all-gather and
  reduce-scatter on a fake 8-rank group as the reference's walker counts
  the same collectives compiled on 8 placeholder devices (a subprocess,
  as ``tests/test_roofline_walker.py`` compiles them).
* The smoke prefill of llama3.2-3b, qwen3-4b and granite-moe-1b-a400m has
  the reference walker's dot FLOPs within ``DOT_TOL`` (the jitted JAX
  prefill on one device, in the same subprocess); rwkv6's ratio is
  printed.
* The dry run of the 2x2 llama3.2-3b cell at full width (4 x 512 tokens,
  2 microbatches) counts the 26,490,003,472 bytes per rank per step that
  the launcher's ``mesh:`` line printed on the card for the same run.
* The memory tracker's peak on meta tensors equals its peak on real CPU
  tensors for a smoke train step on one device.
* The command line writes an ``ok`` record; ``reanalyze`` reproduces its
  ``cost`` from the op log and ``report`` prints its rows.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, ShapeCfg, list_archs, smoke_config
from repro_torch.launch import tuned as port_tuned
from repro_torch.models import get_model, model_class
from repro_torch.roofline import op_cost
from repro_torch.roofline import report as port_report

REPO = Path(__file__).resolve().parent.parent
ARCHS = list_archs()
DOT_TOL = 0.02                        # relative, prefill dot FLOPs
DOT_ARCHS = ("llama3.2-3b", "qwen3-4b", "granite-moe-1b-a400m")
PREFILL = (2, 64)                     # batch x tokens of the smoke prefills
# the launcher's mesh: line for llama3.2-3b full width on 2x2, 4 x 512
# tokens in 2 microbatches, as the card run of that cell printed it (PERF.md)
SCALE_BYTES = 26_490_003_472


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO / "src"),
            "OMP_NUM_THREADS": "1", **extra}


# ---------------------------------------------------------------------------
# report.py and tuned.py against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_per_step_equals_the_reference(arch, shape):
    from repro.roofline import report as ref_report
    assert port_report.model_flops_per_step(arch, shape) == \
        ref_report.model_flops_per_step(arch, shape)


def test_skip_table_equals_the_reference():
    from repro.roofline import report as ref_report
    assert port_report.skip_table() == ref_report.skip_table()


def test_tuned_table_equals_the_reference():
    from repro.launch import tuned as ref_tuned
    assert port_tuned.TUNED == ref_tuned.TUNED


@pytest.mark.parametrize("arch", ARCHS)
def test_tuned_overrides_equal_the_reference(arch):
    from repro.launch import tuned as ref_tuned
    for shape in [*SHAPES, None]:
        for mesh in ("single", "multi", None):
            assert port_tuned.tuned_overrides(arch, shape, mesh) == \
                ref_tuned.tuned_overrides(arch, shape, mesh), (shape, mesh)


def test_roofline_terms_use_the_card():
    from repro_torch.roofline import hw
    rec = {"arch": "llama3.2-3b", "shape": "train_4k", "devices": 256,
           "cost": {"flops_per_device": 989e12, "bytes_per_device": 3.35e12,
                    "coll_bytes_per_device": 450e9}}
    r = port_report.roofline_terms(rec)
    assert (r["t_c"], r["t_m"], r["t_x"]) == (1.0, 1.0, 1.0)
    assert hw.HBM_PER_CHIP == 80e9


# ---------------------------------------------------------------------------
# op_cost on small programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_matmul_chain_dot_flops(device):
    m, k, n, steps = 64, 256, 256, 8
    x = torch.ones((m, k), device=device)
    ws = [torch.full((k, n), 1e-3, device=device) for _ in range(steps)]
    oc = op_cost.OpCost((x, ws))
    with oc:
        for w in ws:
            x = torch.tanh(x @ w)
    cost = oc.cost()
    oc.close()
    assert cost["flops_by_op"]["dot"] == 2 * m * n * k * steps
    # each mm reads x and w and writes x, each tanh reads and writes x
    per = (m * k + k * n + m * n) * 4 + 2 * m * n * 4
    assert cost["bytes_per_device"] == per * steps


def test_views_are_free_and_in_place_writes_counted():
    x = torch.empty((4, 8), device="meta")
    src = torch.empty((4, 2), device="meta")
    idx = torch.empty((2,), dtype=torch.int64, device="meta")
    oc = op_cost.OpCost((x, src, idx))
    with oc:
        x.t().reshape(8, 4)[:2]            # views: nothing
        x.index_copy_(1, idx, src)         # reads idx and src, writes src
        x.add_(1.0)                        # reads and writes x
    recs = oc.records()
    oc.close()
    assert [r["op"] for r in recs] == ["index_copy_", "add_"]
    assert op_cost.op_bytes(recs[0]) == 2 * 8 + 2 * 4 * 2 * 4
    assert op_cost.op_bytes(recs[1]) == 2 * 4 * 8 * 4


REF_SCRIPT = r'''
import json
import jax, jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import smoke_config
from repro.models import get_model
from repro.parallel.logical import values_of
from repro.roofline.hlo_parse import analyze_hlo_text

mk = ({"axis_types": (jax.sharding.AxisType.Auto,)}
      if hasattr(jax.sharding, "AxisType") else {})
mesh = jax.make_mesh((8,), ("data",), **mk)
out = {}

def coll(f, *shapes, **shard):
    with mesh:
        comp = jax.jit(f, **shard).lower(*shapes).compile()
    return analyze_hlo_text(comp.as_text(), 8,
                            bf16_normalize=False)["coll_counts"]

x = jax.ShapeDtypeStruct((8, 1024), jnp.float32)
# test_allreduce_ring_accounting's program: f32[1024] over 8 devices
out["all-reduce"] = coll(
    lambda a: a.sum(axis=0), x,
    in_shardings=(NamedSharding(mesh, P("data", None)),),
    out_shardings=NamedSharding(mesh, P(None)))["all-reduce"]
# each device's f32[1, 1024] row, gathered
out["all-gather"] = coll(
    lambda a: a * 2, x,
    in_shardings=(NamedSharding(mesh, P("data", None)),),
    out_shardings=NamedSharding(mesh, P(None, None)))["all-gather"]
# each device's f32[1024] summed over 8, 128 values kept
out["reduce-scatter"] = coll(shard_map(
    lambda a: lax.psum_scatter(a, "data", tiled=True), mesh=mesh,
    in_specs=P("data"), out_specs=P("data")),
    jax.ShapeDtypeStruct((8 * 1024,), jnp.float32))["reduce-scatter"]

for arch in ARCHS:
    cfg = smoke_config(arch)
    api = get_model(cfg)
    params = values_of(api.init_params(jax.random.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct(PREFILL, jnp.int32)
    comp = jax.jit(lambda p, t: api.prefill(p, t, PREFILL[1])).lower(
        params, toks).compile()
    out[arch] = analyze_hlo_text(comp.as_text(), 1,
                                 bf16_normalize=False)["flops_by_op"]
# imported last: the module sets its own XLA_FLAGS, read only by a
# backend that has not started yet
from repro.launch.dryrun import all_cells
out["all_cells"] = all_cells(["single", "multi"])
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    code = (f"ARCHS = {DOT_ARCHS + ('rwkv6-7b',)!r}\n"
            f"PREFILL = {PREFILL!r}\n" + REF_SCRIPT)
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture
def fake8():
    """The default process group on the fake backend, 8 ranks, rank 0."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import _FakeGroup
    with _FakeGroup(8):
        yield dist.group.WORLD


@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter"])
def test_ring_bytes_equal_the_reference_walker(reference, fake8, op):
    from repro_torch.parallel import collectives as C
    oc = op_cost.OpCost()
    with oc:
        if op == "all-reduce":
            C.all_reduce(torch.empty(1024, device="meta"), fake8)
        elif op == "all-gather":
            C.all_gather(torch.empty((1, 1024), device="meta"), fake8)
        else:
            C.reduce_scatter(torch.empty(1024, device="meta"), fake8)
    cost = oc.cost()
    oc.close()
    want = reference[op]
    got = cost["coll_counts"][op]
    assert (got["count"], got["bytes"]) == (want["count"], want["bytes"])
    assert cost["coll_bytes_per_device"] == want["bytes"]


def _port_prefill_flops(arch: str) -> dict:
    cfg = smoke_config(arch)
    api = get_model(cfg)
    model = model_class(cfg)(cfg, device="meta")
    toks = torch.empty(PREFILL, dtype=torch.int32, device="meta")
    oc = op_cost.OpCost()
    with oc:
        api.prefill(model, toks, PREFILL[1])
    cost = oc.cost()
    oc.close()
    return cost["flops_by_op"]


@pytest.mark.parametrize("arch", DOT_ARCHS)
def test_prefill_dot_flops_equal_the_reference_walker(reference, arch):
    got = _port_prefill_flops(arch)["dot"]
    want = reference[arch]["dot"]
    assert abs(got - want) <= DOT_TOL * want, (got, want)


def test_rwkv6_prefill_dot_flops_ratio_printed(reference):
    got = _port_prefill_flops("rwkv6-7b")["dot"]
    want = reference["rwkv6-7b"]["dot"]
    print(f"rwkv6-7b smoke prefill {PREFILL}: dot FLOPs {got} against the "
          f"reference walker's {want} (ratio {got / want:.6f})")
    assert got > 0 and want > 0


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_scale_cell_counts_the_card_runs_bytes():
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("llama3.2-3b", ShapeCfg("train_4x512", 512, 4, "train"),
                   (2, 2), microbatches=2)
    assert rec["ok"] and rec["devices"] == 4
    assert rec["cost"]["coll_in_bytes_per_device"] == SCALE_BYTES
    assert sum(v["in_bytes"] for v in rec["cost"]["coll_counts"].values()) \
        == SCALE_BYTES
    assert rec["memory"]["fits"]


def _smoke_step_memory(device: str) -> dict:
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.train import make_train_step

    cfg = smoke_config("llama3.2-3b")
    api = get_model(cfg)
    model = model_class(cfg)(cfg, device=device)
    if device != "meta":
        model.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(dict(model.named_parameters()))
    # copies: the pipeline's rows are views of one (4, 33) array
    batch = {k: torch.as_tensor(v).clone().to(device) for k, v in
             SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=4)).batch(0).items()}
    step = make_train_step(api, constant_lr(1e-3), microbatches=2)
    oc = op_cost.OpCost((dict(model.named_parameters()), opt, batch))
    with oc:
        out = step(model, opt, batch)
    mem = oc.memory(out)
    cost = oc.cost()
    oc.close()
    return {"memory": mem, "flops": cost["flops_per_device"],
            "bytes": cost["bytes_per_device"]}


def test_memory_peak_on_meta_equals_the_cpu():
    meta = _smoke_step_memory("meta")
    cpu = _smoke_step_memory("cpu")
    assert meta == cpu
    mem = meta["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["total_bytes"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"]


def test_command_line_reanalyze_and_report(tmp_path):
    out = tmp_path / "dryrun"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    tag = "whisper-tiny__decode_32k__single"
    rec = json.loads((out / f"{tag}.json").read_text())
    assert rec["ok"] and rec["devices"] == 256 and rec["kind"] == "decode"
    assert rec["batch_per_rank"] == SHAPES["decode_32k"].global_batch // 16
    assert (out / f"{tag}.ops.gz").exists()
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["cost"]["coll_counts"]["all-gather"]["count"] > 0
    assert not math.isnan(rec["memory"]["total_bytes"])

    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.roofline.reanalyze", str(out)],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    again = json.loads((out / f"{tag}.json").read_text())
    assert again["cost_raw"] == rec["cost"]
    assert again["cost"] == rec["cost"]

    r = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report",
                        str(out)], capture_output=True, text=True,
                       timeout=600, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [ln for ln in r.stdout.splitlines()
            if ln.startswith("| whisper-tiny | decode_32k |")]
    assert len(rows) == 2           # the dry-run row and the roofline row
    assert "(1/1 cells traced)" in r.stdout
    assert "16x16 = 256 ranks" in r.stdout

    r = subprocess.run([sys.executable, "scripts/torch_make_experiments.py",
                        "--dryrun", str(out), "--out", str(tmp_path)],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    text = (tmp_path / "EXPERIMENTS.md").read_text()
    assert "989 TFLOP/s bf16" in text and "TPU" not in text
    assert sum(ln.startswith("| whisper-tiny | decode_32k |")
               for ln in text.splitlines()) == 2


def test_all_cells_are_the_references(reference):
    from repro_torch.launch.dryrun import all_cells
    cells = all_cells(["single", "multi"])
    assert cells == [tuple(c) for c in reference["all_cells"]]
    assert len(cells) == 64


# ---------------------------------------------------------------------------
# examples/torch_pareto_sweep.py against examples/pareto_sweep.py
# ---------------------------------------------------------------------------


def test_pareto_sweep_prints_the_references_report():
    arch = "granite-moe-1b-a400m"
    ref = subprocess.run([sys.executable, "examples/pareto_sweep.py",
                          "--arch", arch], capture_output=True, text=True,
                         timeout=600, cwd=REPO,
                         env=_env(JAX_PLATFORMS="cpu"))
    port = subprocess.run([sys.executable, "examples/torch_pareto_sweep.py",
                           "--arch", arch, "--device", "cpu"],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=_env())
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    assert port.stdout == ref.stdout
    assert f"best macro for {arch}" in port.stdout
    assert np.isfinite(float(port.stdout.split("—")[-1].split()[0]))
