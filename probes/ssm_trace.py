#!/usr/bin/env python3
"""Probe: where the time of one ``ssm_scan`` call goes on the card.

    python3 probes/ssm_trace.py

Needs one CUDA card.  At each shape of ``chip_smoke.py``'s ssm phase, with
its inputs (seed 0) and the default tile (depth 2), it warms the kernels
up, then traces five calls with ``torch.profiler`` and prints, for the
last call, each kernel's start (from the call's first kernel) and
duration, and the span from the first kernel's start to the last one's
end.  Device times only: the tracer's own cost falls on the host.
"""

import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.ssm_scan import ssm_chunks, ssm_scan  # noqa: E402

SHAPES = ((1024, 262_144), (1024, 256), (4096, 256), (1000, 300))
CALLS = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_trace: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for t, d in SHAPES:
        a = 0.8 + 0.2 * torch.rand((t, d), generator=g, device="cuda")
        b = torch.randn((t, d), generator=g, device="cuda")
        h0 = torch.randn((d,), generator=g, device="cuda")
        for _ in range(3):
            ssm_scan(a, b, h0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                ssm_scan(a, b, h0)
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        per_call = len(kernels) // CALLS
        last = kernels[-per_call:]
        t0 = last[0][0]
        print(f"{t}x{d} (S = {ssm_chunks(t, d)[0]}): {per_call} kernels a "
              f"call; last call spans {last[-1][1] - t0:.3f} us", flush=True)
        for start, end, name in last:
            print(f"  {name[:60]}: start +{start - t0:.3f} us, "
                  f"{end - start:.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
