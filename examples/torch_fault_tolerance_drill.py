"""Fault-tolerance drill on the torch port: train with injected failures
and verify the checkpoint/restart path reproduces the failure-free run
exactly (deterministic counter-based data pipeline => exactly-once step
semantics).  The port of ``examples/fault_tolerance_drill.py``.

    PYTHONPATH=src python examples/torch_fault_tolerance_drill.py --device cpu
    PYTHONPATH=src python examples/torch_fault_tolerance_drill.py   # the card

The state checkpointed each time is the JAX package's training-state
layout (``repro_torch.convert.train_state_to_numpy``); the final
parameters and moments of the two runs must be equal, leaf for leaf.  On
the card, ``--deterministic`` runs under
``torch.use_deterministic_algorithms`` (the embedding's backward otherwise
sums with atomics, in no fixed order); it needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment.
"""

import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.ckpt import (CheckpointManager, FailureInjector,
                              run_with_restarts)
from repro_torch.configs import smoke_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.optim import constant_lr
from repro_torch.train import init_train_state, make_train_step


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(_leaves(a), _leaves(b)))


# the reference's restart drill (tests/test_substrate.py): 20 steps, a
# checkpoint every 5, failures injected at steps 7 and 13
STEPS, SAVE_EVERY, FAIL_AT = 20, 5, (7, 13)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    dev = resolve_device(args.device)

    cfg = smoke_config("llama3.2-3b")
    api = get_model(cfg)
    fr = cfg.frontend
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=8,
        frontend_tokens=fr.n_tokens if fr else 0,
        frontend_dim=fr.d_frontend if fr else 0))
    train_step = make_train_step(api, constant_lr(1e-3))

    def make_state():
        model, opt = init_train_state(
            api, torch.Generator(device=dev).manual_seed(0), device=dev)
        params, opt = train_state_to_numpy(cfg, model, opt)
        return {"params": params, "opt": opt, "step": 0}

    def step_fn(step, state):
        model, opt = train_state_from_numpy(
            cfg, (state["params"], state["opt"]), device=dev)
        model, opt, metrics = train_step(model, opt, corpus.batch(step))
        params, opt = train_state_to_numpy(cfg, model, opt)
        return {"params": params, "opt": opt, "step": step,
                "loss": float(metrics["loss"])}

    tmp1, tmp2 = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        # clean run
        clean = run_with_restarts(step_fn, make_state(), STEPS,
                                  CheckpointManager(tmp1, keep=2),
                                  save_every=SAVE_EVERY)
        # faulty run: injected failures
        mgr = CheckpointManager(tmp2, keep=2)
        mgr.save(0, make_state())
        faulty = run_with_restarts(step_fn, make_state(), STEPS, mgr,
                                   save_every=SAVE_EVERY,
                                   injector=FailureInjector(fail_at=FAIL_AT))
    finally:
        shutil.rmtree(tmp1)
        shutil.rmtree(tmp2)
    same = (faulty["restarts"] == len(FAIL_AT)
            and _same((clean["params"], clean["opt"]),
                      (faulty["params"], faulty["opt"])))
    print(f"device {dev}: {cfg.name}, {STEPS} steps, failures at {FAIL_AT}")
    print(f"clean final loss : {clean['loss']:.6f} "
          f"(restarts={clean['restarts']})")
    print(f"faulty final loss: {faulty['loss']:.6f} "
          f"(restarts={faulty['restarts']})")
    print(f"exactly-once restart semantics: {'PASS' if same else 'FAIL'}")
    assert same


if __name__ == "__main__":
    main()
