#!/usr/bin/env python3
"""Probe: statement order and load distance of the ``csa_tree`` register
kernel, from 64 to 512 rows, on one card.

    python3 probes/csa_tall.py

Needs one CUDA card and ``nvcc``.  It keeps no kernel text of its own:
every variant is ``codegen.source(rows, use_compressors)`` of the
package with ``codegen.window`` replaced by a fixed window, built by
``repro_torch.kernels.build`` into ``build/kernels/``:

  window <w>   window order with w-row windows (rows loaded w ahead of
               their first op); ``window <rows>`` is the schedule's own
               level order with every row loaded first, the order of the
               register kernel before window order (``codegen.window``
               picks one of these per row count and compressor setting);
  torch.sum    ``torch.sum(x, 0, dtype=torch.int32)``.

For each variant, with and without compressors, it prints ptxas's
registers and spill bytes, then, on every stack whose row count it was
built for, checks the column sums equal to the plain version (a variant
that spills is reported but not run) and times it as ``chip_smoke.py``
times a kernel (CUDA events, L2 flushed before each call, median), in two
rounds run in turns.  Stacks: the qwen3-4b wk product's K-chunks of 64
and 256 rows (64 and 256 x 262,144), a 128-row tile walked over 2560 x
262,144, and whole stacks of 300 x 1,000 and 512 x 65,536.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _time_ms  # noqa: E402
from repro_torch.kernels.build import build_source, ptxas_report  # noqa: E402
from repro_torch.kernels.csa_tree import codegen, csa_tree_ref  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int

# (label, kernel rows R, stack height H, columns N, reps)
STACKS = (("64x262144", 64, 64, 262_144, 20),
          ("256x262144", 256, 256, 262_144, 20),
          ("tiled 2560x262144 (bh 128)", 128, 2560, 262_144, 8),
          ("300x1000", 300, 300, 1_000, 20),
          ("512x65536", 512, 512, 65_536, 20))
WINDOWS = (64, 128, 256)


def variants(rows: int) -> list[tuple[int, bool]]:
    """(window, use_compressors) of every distinct variant at ``rows``."""
    return [(w, c) for w in sorted({min(w, rows) for w in WINDOWS} | {rows})
            for c in (True, False)]


def variant_source(rows: int, window: int, use_compressors: bool) -> str:
    """The package's source for ``rows`` rows in ``window``-row windows."""
    picked = codegen.window
    codegen.window = lambda rows, use_compressors: window
    try:
        return codegen.source(rows, use_compressors)
    finally:
        codegen.window = picked


def build(rows: int, window: int, use_compressors: bool, text: str):
    """(library or None if it spills, ptxas report line) of a variant."""
    comp = "c42" if use_compressors else "fa"
    path = build_source(f"csa_tree_probe_w{window}_r{rows}_{comp}", text)
    use = list(ptxas_report(path.with_suffix(".log").read_text()).values())
    spills = sum(u["spill_stores"] + u["spill_loads"] for u in use)
    line = (f"R={rows} window {window} {comp}: registers "
            f"{max(u['registers'] for u in use)}, spill stores/loads "
            f"{sum(u['spill_stores'] for u in use)}/"
            f"{sum(u['spill_loads'] for u in use)} B")
    if spills:
        return None, line
    lib = ctypes.CDLL(str(path))
    lib.csa_tree_reg.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.csa_tree_reg.restype = _I
    return lib, line


def main() -> int:
    if not torch.cuda.is_available():
        print("csa_tall: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    keys = [(rows, w, c) for rows in sorted({r for _, r, _, _, _ in STACKS})
            for w, c in variants(rows)]
    # the texts come from a patched codegen: make them all before the
    # parallel builds
    texts = {key: variant_source(*key) for key in keys}
    with ThreadPoolExecutor(max_workers=len(keys)) as pool:
        built = list(pool.map(lambda key: build(*key, texts[key]), keys))
    libs = {}
    for key, (lib, line) in zip(keys, built):
        libs[key] = lib
        print(line, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, rows, h, n, reps in STACKS:
        x = torch.randint(-2 ** 16, 2 ** 16, (h, n), generator=g,
                          device="cuda", dtype=torch.int32)
        want = csa_tree_ref(x)
        runs = {}
        for w, c in variants(rows):
            lib = libs[rows, w, c]
            if lib is None:
                continue
            name = f"window {w} {'c42' if c else 'fa'}"

            def run(lib=lib, name=name):
                out = torch.empty(n, dtype=torch.int32, device="cuda")
                err = lib.csa_tree_reg(x.data_ptr(), out.data_ptr(), h, n,
                                       256, torch.cuda.current_stream()
                                       .cuda_stream)
                if err:
                    raise RuntimeError(f"{label} {name}: CUDA error {err}")
                return out
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} {name}: wrong column sums")
            runs[name] = run
        runs["torch.sum"] = lambda: torch.sum(x, 0, dtype=torch.int32)
        times = {name: [] for name in runs}
        for _ in range(2):
            for name, fn in runs.items():
                times[name].append(_time_ms(fn, reps))
        for name, (t0, t1) in times.items():
            print(f"{label}: {name}: {t0:.6f} ms, {t1:.6f} ms", flush=True)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
