"""End-to-end training driver on the torch port: a DCIM-quantized (QAT)
language model trained with the full substrate — synthetic data pipeline,
AdamW, checkpointing with restart, metrics.  The port of
``examples/train_lm_dcim.py``.

    PYTHONPATH=src python examples/torch_train_lm_dcim.py --preset tiny \\
        --steps 200 --device cpu
    PYTHONPATH=src python examples/torch_train_lm_dcim.py --preset 100m \\
        --steps 300                                  # the CUDA card

``tiny`` (~3M params) runs a few hundred steps on a CPU; ``100m`` is the
same driver at ~100M params for the card.  Every linear layer runs the
paper's DCIM execution semantics (INT8 weights / INT8 bit-serial
activations via straight-through fake-quant), so the loss curve *is* the
QAT curve of a SynDCIM-mapped model.  Checkpoints are in the JAX package's
format.
"""

import argparse
import time

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.convert import (train_state_from_numpy, train_state_layout,
                                 train_state_to_numpy)
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.train import init_train_state, make_train_step


def preset(name: str):
    cfg = smoke_config("llama3.2-3b")
    if name == "tiny":
        return cfg.replace(name="tiny-dcim-lm", n_layers=4, d_model=128,
                           n_heads=4, n_kv_heads=2, d_ff=512, vocab=4096,
                           head_dim=32), 16, 128
    if name == "100m":
        return cfg.replace(name="lm-100m-dcim", n_layers=12, d_model=768,
                           n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32768,
                           head_dim=64), 32, 512
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, batch_size, seq_len = preset(args.preset)
    api = get_model(cfg)
    print(f"model {cfg.name}: ~{cfg.param_count() / 1e6:.1f}M params, "
          f"DCIM INT{cfg.dcim_a_bits}xINT{cfg.dcim_w_bits} QAT, on {dev}")

    model, opt = init_train_state(api, device=dev)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=batch_size))
    lr = linear_warmup_cosine(3e-4, warmup=20, total_steps=args.steps)
    step_fn = make_train_step(api, lr)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    if args.resume and mgr.latest_step() is not None:
        tree, start = mgr.restore(train_state_layout(cfg))
        model, opt = train_state_from_numpy(cfg, tree, device=dev)
        print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        model, opt, metrics = step_fn(model, opt, corpus.batch(step))
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:4d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"lr={float(metrics['lr']):.2e}  [{dt:.1f}s]")
        if (step + 1) % args.save_every == 0:
            mgr.async_save(step + 1, train_state_to_numpy(cfg, model, opt))
    mgr.wait()
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
