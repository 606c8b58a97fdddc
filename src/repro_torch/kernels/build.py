"""Build a hand-written CUDA source into a shared library at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the repository
root, under a name keyed on the hash of the source: an edited source builds
anew, an unchanged one is reused.  A generated source (the ``csa_tree``
register kernels, one per row count) is built the same way from its text
(:func:`build_source`), and the text is kept beside its library.  The
library is loaded with ``ctypes`` by the kernel's binding module.  The
build is atomic (a temporary file renamed into place), so processes that
race on it agree on the result.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library
as ``<name>.log``; :func:`ptxas_report` reads it.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

#: The package's CUDA sources.
CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: Where libraries are built: ``build/kernels`` at the repository root.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current text."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(src: Path, out: Path) -> Path:
    """nvcc ``src`` into ``out`` unless it is already built; the ptxas
    report goes beside it.  Raises with nvcc's output on failure."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {res.returncode}) on "
                           f"{src.name}:\n{res.stdout}{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built, and
    return the library's path."""
    return _compile(CSRC / f"{name}.cu", library_path(name))


def source_library_path(name: str, text: str) -> Path:
    """Where the library of the generated source ``text`` lives: keyed on
    the hash of the text, so another text builds anew."""
    digest = hashlib.sha256(text.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_source(name: str, text: str) -> Path:
    """Compile the generated CUDA source ``text`` unless its library is
    already built, and return the library's path.  The text is written
    beside the library as ``<name>-<hash>.cu``."""
    out = source_library_path(name, text)
    if out.exists():
        return out
    src = out.with_name(f"{out.stem[3:]}.cu")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, src)
    return _compile(src, out)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SERIAL = re.compile(r"wgmma\.mma_async instructions are serialized.*"
                     r"in the function '([^']+)'")


def wgmma_serialized(log: str) -> set[str]:
    """The kernels of a ``-Xptxas -v`` log whose ``wgmma`` pipeline ptxas
    serialized (warning C7520): each ``wgmma`` then waits for the one
    before it."""
    return {m[1] for m in _SERIAL.finditer(log)}


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel of a ``-Xptxas -v`` log: its registers and the bytes of
    its spill stores and loads."""
    out: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = out.setdefault(m[1], {"registers": 0, "spill_stores": 0,
                                          "spill_loads": 0})
        elif entry is None:
            continue
        elif m := _SPILL.search(line):
            entry["spill_stores"] = int(m[1])
            entry["spill_loads"] = int(m[2])
        elif m := _REGS.search(line):
            entry["registers"] = int(m[1])
    return out
