#!/usr/bin/env python3
"""Probe: how the chunk count S of the chunked ``ssm_scan`` sets its time
on narrow states, on one card.

    python3 probes/ssm_split.py

Needs one CUDA card.  At each narrow shape of ``chip_smoke.py``'s ssm
phase, with its inputs (seed 0) and the default tile (depth 2), it runs
the package's kernel with the split replaced by S chunks of ceil(T / S)
rows (``kernel.ssm_chunks`` patched; S = the split ``ssm_chunks`` picks is
marked), holds each output to ``ssm_scan_chunked_ref`` with the same S
bit for bit, and times it as ``chip_smoke.py`` times a kernel (CUDA
events, L2 flushed before each call, median of 20), in two rounds run in
turns.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _time_ms  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,  # noqa: E402
                                          ssm_scan_chunked_ref)

SHAPES = ((1024, 256), (4096, 256), (1000, 300))
CHUNKS = (4, 8, 16, 32, 64, 128)


def with_chunks(s: int):
    def split(t: int, d: int) -> tuple[int, int]:
        rows = -(-t // s)
        return -(-t // rows), rows
    return split


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_split: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for t, d in SHAPES:
        a = 0.8 + 0.2 * torch.rand((t, d), generator=g, device="cuda")
        b = torch.randn((t, d), generator=g, device="cuda")
        h0 = torch.randn((d,), generator=g, device="cuda")
        picked = ssm_chunks(t, d)[0]
        times = {}
        for _ in range(2):
            for s in sorted(set(CHUNKS) | {picked}):
                kernel.ssm_chunks = with_chunks(s)
                try:
                    got = ssm_scan(a, b, h0)
                    want = ssm_scan_chunked_ref(a, b, h0, s)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise RuntimeError(f"{t}x{d} S={s}: differs from "
                                           f"the chunked plain version")
                    times.setdefault(s, []).append(
                        _time_ms(lambda: ssm_scan(a, b, h0)))
                finally:
                    kernel.ssm_chunks = ssm_chunks
        for s, (t0, t1) in times.items():
            mark = " (ssm_chunks)" if s == picked else ""
            print(f"{t}x{d} S={s}{mark}: {t0:.6f} ms, {t1:.6f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
