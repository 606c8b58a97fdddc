"""Training launcher (the port of the JAX package's
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 50 --device cpu            # the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 6 --batch 4 --seq 512 --microbatches 2   # full width, card
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --device cpu --backend gloo --mesh 2x2   # 4 CPU ranks

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.  The
parameters are drawn from a generator on the device seeded 0 (no weights
are read); the deterministic data pipeline feeds the train step, and
checkpoints are saved asynchronously every ``--save-every`` steps in the
JAX package's format, a run resuming from the latest one under
``--ckpt-dir``.

Under ``torch.distributed.run`` the ranks join one process group with
``--backend`` (``nccl``, one card per rank, or ``gloo``, which also runs
several ranks on one card or on the CPU), and ``--mesh DxM`` (or
``PxDxM``) is a mesh of those ranks: the parameters and AdamW moments are
sharded by the logical rules, each rank keeping its pieces of the
one-device draw, and every step takes the global batch
(:mod:`repro_torch.train.step`).  A mesh wider than the world shrinks by
the reference's rule (:func:`repro_torch.launch.mesh.make_host_mesh`); a
mesh of one rank is the one-device path.  Rank 0 prints the reference's
lines, then the group's backend (:func:`repro_torch.launch.mesh.
group_line`), and writes the checkpoints, which hold the global arrays, so
a run saved on one mesh resumes on another (the restored global arrays are
placed by :func:`repro_torch.ckpt.elastic.reshard_tree`).  ``--tuned`` sets
``act_shard``, the reference's activation constraints; in the port they
change nothing, since its activations are never sharded
(:func:`repro_torch.parallel.sharding.constrain_act`).
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..configs import get_config, smoke_config
from ..convert import (train_state_from_numpy, train_state_layout,
                       train_state_to_numpy)
from ..data import DataConfig, SyntheticCorpus
from ..models import get_model
from ..optim.adamw import AdamWConfig
from ..optim.schedules import linear_warmup_cosine
from ..parallel import collectives as C
from ..train.step import init_train_state, make_train_step
from .mesh import (BACKENDS, group_line, init_distributed, is_main,
                   make_host_mesh, mesh_dims, parse_mesh)
from .serve import _sync


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU runs)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card; "
                         "'cpu' for the CPU)")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--backend", choices=BACKENDS, default="nccl",
                    help="process-group backend under "
                         "torch.distributed.run (gloo for several ranks "
                         "on one card or on the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tuned", action="store_true",
                    help="set act_shard, the reference's activation "
                         "sharding constraints; they change nothing in "
                         "the port, whose activations are never sharded")
    ap.add_argument("--ckpt-dir", default="artifacts/train")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    return ap


def _placement_line(model, mesh, dev) -> str:
    """How much of the model each rank holds: the share of the elements of
    the leaves sharded over every mesh axis, gathered to every rank (a
    collective: all ranks call it)."""
    full = [p for p in model.parameters()
            if all(pl.is_shard() for pl in p.placements)]
    local = sum(p.to_local().numel() for p in full)
    total = sum(p.numel() for p in full)
    every = C.all_gather(torch.tensor([local], dtype=torch.int64,
                                      device=dev), None, 0).tolist()
    return (f"mesh: {len(full)} leaves sharded over all of "
            f"{tuple(mesh.mesh_dim_names)} ({total} elements); share held "
            f"per rank {[round(n / total, 6) for n in every]}")


def _mesh_line(mesh, dev, step_ms: list, step_bytes: list) -> str:
    """Every rank's peak device memory and collective bytes per step,
    gathered to every rank (a collective: all ranks call it)."""
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    mine = torch.tensor([[peak, sum(step_bytes) // max(len(step_bytes), 1)]],
                        dtype=torch.int64, device=dev)
    every = C.all_gather(mine, None, 0).tolist()
    return (f"mesh: ms per step {[round(x, 3) for x in step_ms]}; peak "
            f"device memory per rank {[r[0] for r in every]} bytes; "
            f"collective bytes per rank per step {[r[1] for r in every]}")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    dev = init_distributed(args.backend, args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.tuned:
        cfg = cfg.replace(act_shard=True)
    api = get_model(cfg)

    dims, axes = parse_mesh(args.mesh)
    mesh = make_host_mesh(dims, axes, device_type=dev.type)
    main_rank = is_main()
    if main_rank:
        print(f"mesh {mesh_dims(mesh)} | arch {cfg.name} "
              f"(~{cfg.param_count() / 1e6:.1f}M params, "
              f"DCIM INT{cfg.dcim_a_bits}xINT{cfg.dcim_w_bits})")
    ranks = None if isinstance(mesh, dict) else mesh

    model, opt = init_train_state(api, device=dev, mesh=ranks)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        frontend_tokens=cfg.frontend.n_tokens if cfg.frontend else 0,
        frontend_dim=cfg.frontend.d_frontend if cfg.frontend else 0))
    lr = linear_warmup_cosine(args.lr, warmup=min(20, args.steps // 5),
                              total_steps=args.steps)
    step_fn = make_train_step(api, lr, AdamWConfig(),
                              microbatches=args.microbatches, mesh=ranks)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, host_id=args.host_id)

    start = 0
    if mgr.latest_step() is not None:
        tree, start = mgr.restore(train_state_layout(cfg))
        del model, opt
        model, opt = train_state_from_numpy(cfg, tree, device=dev,
                                            mesh=ranks)
        del tree
        if main_rank:
            print(f"resumed from step {start}")

    if ranks is not None:
        line = _placement_line(model, ranks, dev)
        if main_rank:
            print(line, flush=True)
    step_ms, step_bytes = [], []
    t0 = time.time()
    for step in range(start, args.steps):
        C.reset_counts()
        t_step = time.perf_counter()
        if ranks is None:
            lo = args.host_id * (args.batch // args.n_hosts)
            hi = lo + args.batch // args.n_hosts
            batch = corpus.batch(step, lo, hi)
        else:                   # every rank takes the global batch
            batch = corpus.batch(step)
        model, opt, m = step_fn(model, opt, batch)
        loss = float(m["loss"])         # waits for the step
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        step_bytes.append(sum(C.TRAFFIC.values()))
        if main_rank and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"[{time.time() - t0:.1f}s]", flush=True)
        if (step + 1) % args.save_every == 0:
            # every rank gathers its pieces; rank 0 writes the global tree
            state = train_state_to_numpy(cfg, model, opt)
            if main_rank:
                mgr.async_save(step + 1, state)
            del state
    _sync(dev)
    mgr.wait()
    if ranks is not None:
        line = _mesh_line(ranks, dev, step_ms, step_bytes)
        if main_rank:
            print(line, flush=True)
    if main_rank:
        print(f"trained {args.steps - start} steps in "
              f"{time.time() - t0:.1f}s")
    if dist.is_initialized():
        line = group_line()
        if main_rank:
            print(line, flush=True)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
