"""Training launcher on one device (the port of the JAX package's
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 50 --device cpu            # the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 6 --batch 4 --seq 512 --microbatches 2   # full width, card

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.  The
parameters are drawn from a generator on the device seeded 0 (no weights
are read); the deterministic host-sharded data pipeline feeds the train
step, and checkpoints are saved asynchronously every ``--save-every`` steps
in the JAX package's format, a run resuming from the latest one under
``--ckpt-dir``.  ``--mesh`` keeps the reference's rule (the shape shrinks
to the visible device count); a mesh that still spans more than one device
raises ``NotImplementedError`` (ROADMAP.md queue 1, item 8c).  The
reference's ``--tuned`` sets ``act_shard``, which one device ignores.
"""

from __future__ import annotations

import argparse
import time

from ..ckpt import CheckpointManager
from ..configs import get_config, smoke_config
from ..convert import (train_state_from_numpy, train_state_layout,
                       train_state_to_numpy)
from ..data import DataConfig, SyntheticCorpus
from ..device import resolve_device
from ..models import get_model
from ..optim.adamw import AdamWConfig
from ..optim.schedules import linear_warmup_cosine
from ..train.step import init_train_state, make_train_step
from .serve import _sync, device_count, make_host_mesh, parse_mesh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU runs)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card; "
                         "'cpu' for the CPU)")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tuned", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/train")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.tuned:
        cfg = cfg.replace(act_shard=True)
    api = get_model(cfg)

    dims, axes = parse_mesh(args.mesh)
    mesh = make_host_mesh(dims, axes, n_devices=device_count(dev))
    print(f"mesh {mesh} | arch {cfg.name} "
          f"(~{cfg.param_count() / 1e6:.1f}M params, "
          f"DCIM INT{cfg.dcim_a_bits}xINT{cfg.dcim_w_bits})")

    model, opt = init_train_state(api, device=dev)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        frontend_tokens=cfg.frontend.n_tokens if cfg.frontend else 0,
        frontend_dim=cfg.frontend.d_frontend if cfg.frontend else 0))
    lr = linear_warmup_cosine(args.lr, warmup=min(20, args.steps // 5),
                              total_steps=args.steps)
    step_fn = make_train_step(api, lr, AdamWConfig(),
                              microbatches=args.microbatches)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, host_id=args.host_id)

    start = 0
    if mgr.latest_step() is not None:
        tree, start = mgr.restore(train_state_layout(cfg))
        del model, opt
        model, opt = train_state_from_numpy(cfg, tree, device=dev)
        del tree
        print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        lo = args.host_id * (args.batch // args.n_hosts)
        hi = lo + args.batch // args.n_hosts
        model, opt, m = step_fn(model, opt, corpus.batch(step, lo, hi))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"[{time.time() - t0:.1f}s]", flush=True)
        if (step + 1) % args.save_every == 0:
            mgr.async_save(step + 1, train_state_to_numpy(cfg, model, opt))
    _sync(dev)
    mgr.wait()
    print(f"trained {args.steps - start} steps in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
