#!/usr/bin/env python3
"""Probe: what the chunked ``ssm_scan``'s second launch and its carry chain
cost on narrow states, on one card.

    python3 probes/ssm_launch.py

Needs one CUDA card.  It builds four variants of ``csrc/ssm_scan.cu``
and runs each through the package's launch function (``kernel._lib``
patched), at each narrow shape of ``chip_smoke.py``'s ssm phase with its
inputs (seed 0), at depth 1 and depth 2:

  pdl       the source as it is: the states launch is a programmatic
            dependent launch of the summary launch, and waits for the
            summaries (``griddepcontrol.wait``) only where its carry chain
            reads them;
  stream    the states launch an ordinary one, ordered after the summary
            launch by the stream (no launch attribute; ``griddepcontrol``
            is then a no-op);
  wait      as ``pdl``, but every chunk starts from h0 instead of its
            carry chain, after the same wait for the summary launch, so
            the difference to ``pdl`` is what walking the chain costs;
  no carry  as ``wait`` without the wait: the difference to ``wait`` is
            what waiting for the summary launch costs.

The outputs of ``wait`` and ``no carry`` are wrong and are not checked.

``pdl`` and ``stream`` are held to ``ssm_scan_chunked_ref`` bit for bit.
Each is timed as ``chip_smoke.py`` times a kernel (CUDA events, L2
flushed before each call, median of 20), the variants in turns, in two
rounds.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _time_ms  # noqa: E402
from repro_torch.kernels import TileConfig  # noqa: E402
from repro_torch.kernels.build import CSRC, build_source  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,  # noqa: E402
                                          ssm_scan_chunked_ref)

SHAPES = ((1024, 256), (4096, 256), (1000, 300))

PDL = "cfg.numAttrs = !kSummary && S > 1 ? 1 : 0;"
CARRY = "h = carry_in(summary, h0, chunk, gridDim.y - 1, D, d);"


def patched(text: str, edits: list[tuple[str, str, int]]) -> str:
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"ssm_scan.cu changed: {old!r} found "
                               f"{text.count(old)} times, want {count}")
        text = text.replace(old, new)
    return text


def variants() -> dict[str, str]:
    text = (CSRC / "ssm_scan.cu").read_text()
    stream = patched(text, [(PDL, "cfg.numAttrs = 0;", 1)])
    wait = patched(text, [(CARRY, "{ if (chunk > 0) wait_for_primary_grid(); "
                                  "h = h0[d]; }", 2)])
    no_carry = patched(text, [(CARRY, "h = h0[d];", 2)])
    return {"pdl": text, "stream": stream, "wait": wait,
            "no carry": no_carry}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_launch: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    libs = {name: kernel.bind(build_source(
        f"ssm_scan_{name.replace(' ', '_')}", text))
        for name, text in variants().items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    shipped = kernel._lib
    try:
        for t, d in SHAPES:
            a = 0.8 + 0.2 * torch.rand((t, d), generator=g, device="cuda")
            b = torch.randn((t, d), generator=g, device="cuda")
            h0 = torch.randn((d,), generator=g, device="cuda")
            want = ssm_scan_chunked_ref(a, b, h0, ssm_chunks(t, d)[0])
            for depth in (1, 2):
                tc = TileConfig(depth=depth)
                times = {}
                for _ in range(2):
                    for name, lib in libs.items():
                        kernel._lib = lambda lib=lib: lib
                        got = ssm_scan(a, b, h0, tile_config=tc)
                        if name in ("pdl", "stream") and not (
                                torch.equal(got[0], want[0])
                                and torch.equal(got[1], want[1])):
                            raise RuntimeError(
                                f"{t}x{d} depth {depth} {name}: differs "
                                f"from the chunked plain version")
                        times.setdefault(name, []).append(_time_ms(
                            lambda: ssm_scan(a, b, h0, tile_config=tc)))
                print(f"{t}x{d} (S = {ssm_chunks(t, d)[0]}) depth {depth}: "
                      + "; ".join(f"{name} {t0:.6f}, {t1:.6f} ms"
                                  for name, (t0, t1) in times.items()),
                      flush=True)
    finally:
        kernel._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
