"""Serving example on the torch port: prefill a batch of prompts, then
batched greedy decode with in-place KV caches (the port of
``examples/serve_decode.py``).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen3-4b \\
        --steps 32                      # on the CUDA card
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

It runs the reduced (smoke) config of the arch, parameters drawn from a
generator on the device seeded 0.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import list_archs, smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import device_name  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import greedy_generate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the CPU)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    api = get_model(cfg)
    model = api.init_params(torch.Generator(device=device).manual_seed(0),
                            device=device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (args.batch, args.prompt_len)),
                              device=device)
    frontend = None
    if cfg.frontend is not None:
        frontend = torch.as_tensor(rng.normal(size=(
            args.batch, cfg.frontend.n_tokens, cfg.frontend.d_frontend)),
            dtype=torch.float32, device=device)

    t0 = time.perf_counter()
    out = greedy_generate(api, model, prompts, args.steps, frontend=frontend)
    out = out.cpu().numpy()          # waits for the device
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} family={cfg.family}")
    print(f"prefill {args.prompt_len} tokens + decode {args.steps} steps "
          f"x batch {args.batch}: {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s on "
          f"{device_name(device)})")
    print(f"generated token ids (row 0): {out[0][:16]} ...")


if __name__ == "__main__":
    main()
