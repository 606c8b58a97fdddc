#!/usr/bin/env python3
"""Probe: where the time of the ``csa_tree`` kernels goes, on one card.

    python3 probes/csa_stage.py

Needs one CUDA card and ``nvcc``.  It keeps no kernel text of its own:
each variant is the package's source, edited in one named place, and built
by ``repro_torch.kernels.build`` into ``build/kernels/``:

  interp       the shared-memory interpreter (``csrc/csa_tree.cu``) on a
               64-row stack in 64-thread blocks, as the rows route ran
               every 64-row stack before the register kernel;
  stage        the same source with the op program replaced by a plain
               sum of the staged lanes: its staging loads alone;
  reg bn128, reg bn256
               the generated register kernel (``csa_tree_rows_cuda``,
               ``csa_tree_tiled_cuda`` with bh 128) in 128- and 256-thread
               blocks;
  reg ldcs     the generated 128-row kernel with streaming loads
               (``__ldcs``) in place of ``__ldg``, 256-thread blocks;
  torch.sum    ``torch.sum(x, 0, dtype=torch.int32)``.

at 64 x 262,144 (one qwen3-4b wk K-chunk of the 64-row macro) and at
2560 x 262,144 (its whole-K stack; the interpreter holds at most 512 rows,
so interp and stage run at 64 rows only).  Every variant's output is first
checked equal to the plain column sum; then each is timed as
``chip_smoke.py`` times a kernel (CUDA events, L2 flushed before each
call, median of 20 calls, 8 at the tall stack), in two rounds run in turns.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _time_ms  # noqa: E402
from repro_torch.kernels.build import (CSRC, build_source,  # noqa: E402
                                       ptxas_report)
from repro_torch.kernels.csa_tree import (build_schedule,  # noqa: E402
                                          codegen, csa_tree_ref,
                                          csa_tree_rows_cuda,
                                          csa_tree_tiled_cuda)

_P, _I = ctypes.c_void_p, ctypes.c_int

# the interpreter's op loop and result store, and what the stage-only
# variant puts in their place
_PROGRAM = re.compile(r"  for \(int i = 0; i < n_ops; \+\+i\) \{.*?\n  \}\n"
                      r"  out\[col\] = static_cast<int32_t>\(lane\[result "
                      r"\* B \+ t\]\);", re.S)
_STAGE_SUM = """  uint32_t sum = 0u;
  for (int h = 0; h < H; ++h) sum += lane[h * B + t];
  out[col] = static_cast<int32_t>(sum);"""


def _load(name: str, text: str) -> ctypes.CDLL:
    lib_path = build_source(name, text)
    for fn, use in ptxas_report(lib_path.with_suffix(".log").read_text()
                                ).items():
        print(f"{name}: {fn}: {use['registers']} registers, spill "
              f"{use['spill_stores']}/{use['spill_loads']} B")
    return ctypes.CDLL(str(lib_path))


def interpreters() -> dict[str, ctypes.CDLL]:
    """The interpreter as the package builds it, and its stage-only
    variant."""
    text = (CSRC / "csa_tree.cu").read_text()
    stage, n = _PROGRAM.subn(_STAGE_SUM, text)
    if n != 1:
        raise RuntimeError("csa_tree.cu: the op loop to replace was not found "
                           "exactly once")
    libs = {"interp": _load("csa_tree_probe_interp", text),
            "stage": _load("csa_tree_probe_stage", stage)}
    for lib in libs.values():
        lib.csa_tree_rows.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.csa_tree_rows.restype = _I
    return libs


def streaming(rows: int) -> ctypes.CDLL:
    """The generated ``rows``-row register kernel with ``__ldcs`` loads."""
    text = codegen.source(rows, True)
    if text.count("__ldg(") != 1:
        raise RuntimeError("csa_tree_reg.cu.in: expected one __ldg load")
    lib = _load(f"csa_tree_probe_ldcs_r{rows}",
                text.replace("__ldg(", "__ldcs("))
    lib.csa_tree_reg.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.csa_tree_reg.restype = _I
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("csa_stage: no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    interp = interpreters()
    ldcs = streaming(128)
    g = torch.Generator(device="cuda").manual_seed(0)

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def check(err: int, name: str) -> None:
        if err != 0:
            raise RuntimeError(f"{name}: launch failed (CUDA error {err})")

    n = 262_144
    for h in (64, 2560):
        x = torch.randint(-2 ** 16, 2 ** 16, (h, n), generator=g,
                          device="cuda", dtype=torch.int32)
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        runs = {}
        if h == 64:
            sched = build_schedule(h)
            ops = torch.as_tensor(sched.ops, dtype=torch.int32,
                                  device="cuda")
            for name, lib in interp.items():
                runs[f"{name} bn64"] = (
                    lambda lib=lib, name=name: check(lib.csa_tree_rows(
                        x.data_ptr(), out.data_ptr(), ops.data_ptr(),
                        len(sched.ops), sched.result, h, n, 64, stream()),
                        name) or out)
            for bn in (128, 256):
                runs[f"reg bn{bn}"] = (
                    lambda bn=bn: csa_tree_rows_cuda(x, bn=bn))
        else:
            for bn in (128, 256):
                runs[f"reg bn{bn}"] = (
                    lambda bn=bn: csa_tree_tiled_cuda(x, bh=128, bn=bn))
            runs["reg ldcs bn256"] = lambda: check(ldcs.csa_tree_reg(
                x.data_ptr(), out.data_ptr(), h, n, 256, stream()),
                "ldcs") or out
        want = csa_tree_ref(x)
        for name, fn in runs.items():
            out.zero_()
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"H={h} {name}: wrong column sums")
        runs["torch.sum"] = lambda: torch.sum(x, 0, dtype=torch.int32)
        times = {name: [] for name in runs}
        for _ in range(2):
            for name, fn in runs.items():
                times[name].append(_time_ms(fn, 20 if h == 64 else 8))
        for name, (t0, t1) in times.items():
            print(f"H={h}: {name}: {t0:.6f} ms, {t1:.6f} ms")
        del x, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
