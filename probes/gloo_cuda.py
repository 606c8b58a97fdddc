#!/usr/bin/env python3
"""Probe: which collectives a gloo process group runs on CUDA tensors.

    python3 probes/gloo_cuda.py [--ranks 4] [--all-pairs]

Needs one CUDA card.  It spawns ``--ranks`` processes on that card, joins
them in a gloo group (``file://`` init under ``build/probe_gloo/``) and
runs :func:`repro_torch.parallel.collectives.probe` on ``cuda`` tensors:
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce`` with
SUM and MAX, and ``broadcast``, each on float32, bfloat16 and int32 (with
``--all-pairs`` each pair in a fresh group of processes, so a collective
that crashes a rank is recorded as ``crashed``), then all of them on
``cpu`` tensors.  Then, each in a fresh group: the port's sharded train
step (smoke llama3.2-3b, one step on a ``(2, ranks/2)`` CUDA mesh) against
the one-device step, and DTensor's own operations on such a mesh step by
step (the last step begun is named if a rank crashes).  It prints each
result as it comes, then one JSON object with the torch and CUDA versions
and every result.
"""

import argparse
import json
import shutil
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _dtensor_check(world: int, work: str) -> dict:
    """DTensor on a CUDA mesh over the gloo group, step by step; rank 0
    writes each step's name to ``dtensor_steps`` before it runs, so a
    crash names the step."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    log = Path(work) / "dtensor_steps"
    out = {}

    def step(name):
        if dist.get_rank() == 0:
            with open(log, "a") as f:
                f.write(name + "\n")

    step("init_device_mesh")
    mesh = init_device_mesh("cuda", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    full = torch.arange(64, dtype=torch.float32,
                        device="cuda").reshape(8, 8)
    step("from_local")
    r, c = mesh.get_local_rank(0), mesh.get_local_rank(1)
    n1 = 8 // (world // 2)
    local = full[4 * r:4 * r + 4, n1 * c:n1 * c + n1].contiguous()
    dt = DTensor.from_local(local, mesh, [Shard(0), Shard(1)],
                            run_check=False, shape=full.shape,
                            stride=full.stride())
    step("to_local")
    out["local_shape"] = list(dt.to_local().shape)
    step("elementwise")
    out["elementwise"] = bool(torch.equal((dt * 2).to_local(), local * 2))
    step("full_tensor")
    out["full_equal"] = bool(torch.equal(dt.full_tensor(), full))
    step("distribute_tensor")
    dt2 = distribute_tensor(full, mesh, [Shard(0), Shard(1)],
                            src_data_rank=None)
    out["distribute_equal"] = bool(torch.equal(dt2.to_local(), local))
    step("full_tensor_backward")
    p = torch.nn.Parameter(dt)
    y = p.full_tensor(grad_placements=[Partial(), Replicate()])
    (y * 2).sum().backward()
    out["grad_local"] = float(p.grad.to_local().sum())
    step("done")
    return out


def _zero_check(world: int) -> dict:
    """The port's sharded train step (smoke llama3.2-3b, batch 4 x 32, one
    step) on a (2, world/2) CUDA mesh against the one-device step."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.schedules import constant_lr
    from repro_torch.parallel import collectives as C
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = smoke_config("llama3.2-3b")
    api = get_model(cfg)
    batch = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=4)).batch(0)
    out = {}
    for name, mesh in (("one", None),
                       ("mesh", make_host_mesh((2, world // 2)))):
        model, opt = init_train_state(api, device="cuda", mesh=mesh)
        step = make_train_step(api, constant_lr(3e-3), mesh=mesh)
        C.reset_counts()
        _, _, m = step(model, opt, batch)
        out[name] = [float(m["loss"]), float(m["grad_norm"])]
    out["calls"] = dict(C.CALLS)
    return out


def worker(rank: int, world: int, work: str, what: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/init",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    from repro_torch.parallel.collectives import PROBE_DTYPES, probe
    try:
        if what == "dtensor":
            res = _dtensor_check(world, work)
        elif what == "zero":
            res = _zero_check(world)
        elif what in ("cpu", "cuda"):
            res = probe(what)
        else:
            op, dtype = what.split(":")
            res = probe("cuda", ops=(op,), dtypes=tuple(
                d for d in PROBE_DTYPES if str(d) == f"torch.{dtype}"))
        if rank == 0:
            (Path(work) / "result.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def run_one(world: int, what: str) -> dict | str:
    """One probe in a fresh group of ``world`` ranks: its result, or how
    the ranks ended when one crashed."""
    work = ROOT / "build" / "probe_gloo" / what.replace(":", "_")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        mp.spawn(worker, args=(world, str(work), what), nprocs=world,
                 join=True)
    except Exception as e:          # a crashed rank is the finding
        return f"crashed: {type(e).__name__}: {str(e)[:160]}"
    return json.loads((work / "result.json").read_text())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--all-pairs", action="store_true",
                    help="each CUDA (collective, dtype) pair in its own "
                         "group of processes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    from repro_torch.parallel.collectives import OPS, PROBE_DTYPES
    res = {"torch": torch.__version__, "cuda_version": torch.version.cuda,
           "cuda": {}}
    if args.all_pairs:
        for op in OPS:
            for dtype in PROBE_DTYPES:
                name = str(dtype).removeprefix("torch.")
                got = run_one(args.ranks, f"{op}:{name}")
                res["cuda"].setdefault(op, {})[name] = (
                    got if isinstance(got, str) else got[op][name])
                print(f"cuda {op} {name}: {res['cuda'][op][name]}",
                      flush=True)
    else:
        res["cuda"] = run_one(args.ranks, "cuda")
        print("cuda:", res["cuda"], flush=True)
    res["cpu"] = run_one(args.ranks, "cpu")
    res["zero"] = run_one(args.ranks, "zero")
    print("zero:", res["zero"], flush=True)
    res["dtensor"] = run_one(args.ranks, "dtensor")
    steps = ROOT / "build" / "probe_gloo" / "dtensor" / "dtensor_steps"
    if steps.exists():
        res["dtensor_steps"] = steps.read_text().split()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
