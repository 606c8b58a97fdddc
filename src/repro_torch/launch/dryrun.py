"""Dry run of every (arch x shape) cell on the production meshes: the port's
own step traced on meta tensors for rank 0 of a fake process group of 256
or 512 ranks, with its FLOPs, bytes, collective traffic and memory per rank
(the port of the JAX package's ``repro/launch/dryrun.py``, which lowers and
compiles each cell on 512 placeholder host devices and walks the HLO).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh single --out artifacts/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A cell builds the meta model, places it on the mesh by the logical rules
(:func:`repro_torch.parallel.zero.shard_model`, each rank's pieces), and
runs what a rank runs: the sharded train step
(:func:`repro_torch.train.step.make_train_step`) on the global batch of
``launch/specs.py``, or prefill / one decode step over this rank's rows
inside :func:`repro_torch.parallel.zero.data_parallel`, as
``launch/serve.py`` runs them over ranks.  The process group is
``torch.distributed``'s "fake" backend at the mesh's world size, joined as
rank 0: its collectives return at once and move nothing, and the port's
counted collectives (:mod:`repro_torch.parallel.collectives`) log each
call.  Every tensor lives on the meta device, so the trace allocates
nothing and computes nothing, on any device; the numbers come from the
shapes alone (:mod:`repro_torch.roofline.op_cost`).  The record's roofline
terms model the card (``roofline/hw.py``'s H100 figures) but no card runs
here: this is neither a CPU fallback nor a measurement of any device.

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` (the reference's
record keys, with ``trace_s`` in place of ``lower_s`` and ``compile_s``)
and its op log ``<tag>.ops.gz``, from which
:mod:`repro_torch.roofline.reanalyze` recomputes ``cost``.  ``--all`` runs
each cell in a subprocess of its own, half as many at once as the host
has cores, skips those already recorded ``ok`` and records a failure with
its stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..configs import SHAPES, ShapeCfg, applicable_shapes, get_config, \
    list_archs
from ..models import get_model, model_class
from ..optim.adamw import adamw_init
from ..optim.schedules import constant_lr
from ..parallel import zero
from ..parallel.sharding import (activation_rules, reset_activation_rules,
                                 rules_for_mesh)
from ..roofline.op_cost import OpCost, analyze, write_ops
from ..train.step import make_train_step
from . import specs as S

SRC = Path(__file__).resolve().parents[2]
# ``--all``: cells traced at once, each a process of one busy core
JOBS = max(1, (os.cpu_count() or 2) // 2)
MESH_KINDS = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def mesh_of(kind) -> tuple[str, tuple[int, ...], tuple[str, ...]]:
    """(name, dims, axes) of a mesh: ``single`` / ``multi``, the
    production meshes, or a tuple of dims (``(2, 2)``: ``('data',
    'model')``)."""
    if isinstance(kind, str):
        dims, axes = MESH_KINDS[kind]
        return kind, dims, axes
    dims = tuple(kind)
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return "x".join(map(str, dims)), dims, axes


class _FakeGroup:
    """The default process group on the "fake" backend at ``world`` ranks,
    joined as rank 0, for the block (none for one rank)."""

    def __init__(self, world: int):
        self.world = world

    def __enter__(self):
        import torch.distributed as dist

        if self.world > 1:
            if dist.is_initialized():
                raise RuntimeError("a dry run needs a process without a "
                                   "process group of its own")
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=self.world)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self.world > 1:
            dist.destroy_process_group()


def _shape_rules(cfg, shape: ShapeCfg, multi: bool) -> dict:
    rules = dict(cfg.sharding_overrides)
    if shape.global_batch == 1:
        # long_500k: a batch of 1 cannot shard; the reference spreads the
        # cached sequence over every mesh axis (context parallelism).  The
        # port's decode reads the whole cache on every rank, so here only
        # the batch rule acts.
        rules.setdefault("batch", None)
        rules.setdefault("kv_seq", ("pod", "data", "model") if multi
                         else ("data", "model"))
        rules.setdefault("act_heads", "model")
    return rules


def run_cell(arch: str, shape_name, mesh_kind, microbatches: int = 1,
             overrides: dict | None = None, ops_out: Path | None = None,
             tuned: bool = False) -> dict:
    """The record of one cell (module doc).  ``shape_name``: a key of
    ``SHAPES`` or a ``ShapeCfg``; ``mesh_kind``: ``single``, ``multi`` or
    a tuple of dims (a mesh of one rank is the one-device path: no
    process group, plain parameters)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    name, dims, axes = mesh_of(mesh_kind)
    if tuned:
        from .tuned import tuned_overrides
        # act_shard is the reference's choice for train and prefill; it
        # changes nothing in the port (launch/tuned.py)
        want_act = shape.kind != "decode"
        merged = {"act_shard": want_act,
                  **tuned_overrides(arch, shape.name, name)}
        merged.update(overrides or {})
        overrides = merged
    if overrides:
        cfg = cfg.replace(**overrides)
    cfg = cfg.replace(sharding_overrides=_shape_rules(
        cfg, shape, "pod" in axes))
    world = math.prod(dims)
    rec = {"arch": arch, "shape": shape.name, "mesh": name,
           "devices": world, "kind": shape.kind,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "act_shard": cfg.act_shard, "overrides": overrides or {},
           "microbatches": microbatches}
    with _FakeGroup(world):
        mesh = None
        if world > 1:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
        return _run_cell_inner(cfg, shape, mesh, rec, microbatches,
                               ops_out)


def _run_cell_inner(cfg, shape, mesh, rec, microbatches, ops_out) -> dict:
    t0 = time.perf_counter()
    api = get_model(cfg)
    model = model_class(cfg)(cfg, device="meta")
    n_dp, rules = 1, None
    over = contextlib.nullcontext()
    if mesh is not None:
        rules = rules_for_mesh(mesh, cfg.sharding_overrides)
        zero.shard_model(model, mesh, rules)
        baxes = zero.batch_axes(mesh, rules)
        n_dp = zero.dp_size(mesh, baxes)
        over = zero.data_parallel(mesh, baxes)
    rows = shape.global_batch // n_dp
    if shape.kind != "train" and rows * n_dp != shape.global_batch:
        raise ValueError(f"a batch of {shape.global_batch} does not split "
                         f"over {n_dp} batch ranks")
    rec["batch_per_rank"] = rows
    params = dict(model.named_parameters())
    if shape.kind == "train":           # the step takes the global batch
        opt = adamw_init(params)
        batch = S.train_batch_specs(cfg, shape)
        step = make_train_step(api, constant_lr(1e-4),
                               microbatches=microbatches, mesh=mesh)
        args = (params, opt, batch)

        def run():
            return step(model, opt, batch)
    elif shape.kind == "prefill":
        toks = S.sds((rows, shape.seq_len), torch.int32)
        fe = None
        if cfg.frontend is not None:
            fe = S.sds((rows, cfg.frontend.n_tokens,
                        cfg.frontend.d_frontend), torch.float32)
        args = (params, toks, fe)

        def run():
            with over:
                return api.prefill(model, toks, shape.seq_len, frontend=fe)
    else:
        state = api.init_decode_state(rows, shape.seq_len, device="meta")
        toks = S.sds((rows, 1), torch.int32)
        args = (params, state, toks)

        def run():
            with over:
                return api.decode_step(model, state, toks)

    token = activation_rules(rules if cfg.act_shard else None)
    oc = OpCost(args)
    try:
        t1 = time.perf_counter()
        with oc:
            out = run()
        rec["trace_s"] = round(time.perf_counter() - t1, 1)
        rec["build_s"] = round(t1 - t0, 1)
        rec["memory"] = oc.memory(out)
        records = oc.records()
    finally:
        oc.close()
        reset_activation_rules(token)
    rec["cost"] = analyze(records)
    if ops_out is not None:
        write_ops(ops_out, records)
    rec["ok"] = True
    return rec


# ---------------------------------------------------------------------------
# the --all runner
# ---------------------------------------------------------------------------


def all_cells(mesh_kinds: list[str]) -> list[tuple[str, str, str]]:
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            for mk in mesh_kinds:
                cells.append((arch, shape, mk))
    return cells


def _run_all(args, outdir: Path) -> int:
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    for arch, shape, mk in all_cells(kinds):
        tag = f"{arch}__{shape}__{mk}"
        path = outdir / f"{tag}.json"
        if path.exists() and json.loads(path.read_text()).get("ok"):
            print(f"[skip] {tag} (cached)")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mk, "--out", str(outdir),
               "--microbatches", str(args.microbatches)]
        if args.tuned:
            cmd.append("--tuned")
        todo.append((tag, path, cmd))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    failures = 0
    running: list = []

    def poll() -> None:
        """Reap the cells that ended (or ran past ``--timeout``)."""
        nonlocal failures
        for item in list(running):
            tag, path, proc, err, t0 = item
            late = time.time() - t0 > args.timeout
            if proc.poll() is None and not late:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            running.remove(item)
            err.seek(0)
            text = err.read().decode(errors="replace")
            err.close()
            if late:
                text += f"\ntimed out after {args.timeout} s"
            if proc.returncode != 0:
                failures += 1
                arch, shape, mk = tag.split("__")
                path.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mk, "ok": False,
                    "error": text[-4000:]}, indent=1))
                print(f"[FAIL] {tag}\n{text[-2000:]}", flush=True)
            else:
                print(f"[done] {tag} in {time.time() - t0:.1f} s",
                      flush=True)

    for tag, path, cmd in todo:
        while len(running) >= JOBS:
            poll()
            time.sleep(0.2)
        print(f"[run ] {tag}", flush=True)
        err = tempfile.TemporaryFile()
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err,
                                env=env)
        running.append((tag, path, proc, err, time.time()))
    while running:
        poll()
        time.sleep(0.2)
    print(f"done; failures={failures}")
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (hillclimb knobs)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tuned", action="store_true",
                    help="apply the tuned overrides (act_shard + "
                         "launch/tuned.py)")
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        return _run_all(args, outdir)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mk in kinds:
        tag = f"{args.arch}__{args.shape}__{mk}"
        rec = run_cell(args.arch, args.shape, mk,
                       microbatches=args.microbatches,
                       overrides=overrides or None,
                       ops_out=outdir / f"{tag}.ops.gz", tuned=args.tuned)
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "trace_s")}))
        print("memory:", rec["memory"])
        print("cost:", rec["cost"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
