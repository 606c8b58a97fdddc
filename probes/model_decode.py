#!/usr/bin/env python3
"""Probe: where the time of one qwen3-4b decode step goes on the card.

    python3 probes/model_decode.py

Needs one CUDA card.  It builds qwen3-4b at its full width (bf16, drawn
from a generator seeded 0, as ``chip_smoke.py``'s model phase does),
prefills 4 prompts of 64 tokens into a 96-token cache, then, for DCIM
fake-quant on (the config) and off (every linear a plain bf16 matmul, the
reference's ``dcim_enabled=False``):

* times 16 decode steps with the host clock, the device synchronised at the
  end (ms per step);
* traces 4 more with ``torch.profiler`` and prints the kernels per step,
  the device time per step (the sum of the kernels' durations), the busy
  share of the traced window, and the ten kernels that take the most
  device time.

The decode step's bound is every weight byte read once at 3.35 TB/s.
"""

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.layers import DcimLinear  # noqa: E402
from repro_torch.serve.step import greedy_argmax  # noqa: E402

BATCH, PROMPT, CACHE = 4, 64, 96
TIMED, TRACED = 16, 4
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    if not torch.cuda.is_available():
        print("model_decode: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    cfg = get_config("qwen3-4b")
    api = get_model(cfg)
    model = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"bound: {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms per step "
          f"({weight_bytes} weight bytes at 3.35 TB/s)", flush=True)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                              device="cuda")
    linears = [m for m in model.modules() if isinstance(m, DcimLinear)]
    for enabled in (True, False):
        for m in linears:
            m.enabled = enabled
        logits, state = api.prefill(model, prompts, CACHE)
        tok = greedy_argmax(logits)
        for _ in range(2):                       # warm-up
            logits, state = api.decode_step(model, state, tok)
            tok = greedy_argmax(logits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            logits, state = api.decode_step(model, state, tok)
            tok = greedy_argmax(logits)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TIMED
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACED):
                logits, state = api.decode_step(model, state, tok)
                tok = greedy_argmax(logits)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.end - e.time_range.start for e in kernels)
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels))
        by_name = defaultdict(lambda: [0, 0.0])
        for e in kernels:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.end - e.time_range.start
        print(f"fake-quant {'on' if enabled else 'off'}: {ms:.3f} ms per "
              f"step (host clock, {TIMED} steps); traced: "
              f"{len(kernels) / TRACED:.0f} kernels per step, device "
              f"{busy / TRACED / 1e3:.3f} ms per step, busy "
              f"{busy / span:.3f} of the kernels' span", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        for name, (count, us) in top:
            print(f"  {us / TRACED / 1e3:8.3f} ms/step {count // TRACED:5d} "
                  f"calls/step  {name[:90]}", flush=True)
        del logits, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
