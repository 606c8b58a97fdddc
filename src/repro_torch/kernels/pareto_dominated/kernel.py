"""ctypes binding of the CUDA eps-band dominance kernel
(``csrc/pareto_dominated.cu``), rows A2 and A3 of the kernel table.

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process (:func:`bind` loads a build of
a variant of its text the same way).  :func:`pareto_dominated_cuda`
checks its operands, allocates the verdicts with ``torch.empty`` and the
passes' scratch (counters, the survivor list and its done flags) with
``torch.zeros`` on the operands' device,
launches, for 1 to :data:`MAX_OBJECTIVES` objectives, the screen pass
and, where some candidate's test is longer than :data:`SCREEN_ROWS` rows,
the split pass on torch's current stream without synchronising (the split
pass reads the survivor count on the device), and for any other count (more
objectives, or none) the wide kernel alone; it raises if a launch was
refused, and counts: one in :data:`LAUNCHES` under its mode per call, one
in :data:`PASS_LAUNCHES` per kernel launched.  It takes CUDA tensors only:
the dispatcher :func:`repro_torch.core.pareto.dominated` runs the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library

#: Calls of the binding, by mode: ``all`` tests each candidate against every
#: row (A2, A3's phase 2), ``seg`` against the rows of its own block (A3's
#: phase 1).  Added to where the call launches its kernels.
LAUNCHES = {"all": 0, "seg": 0}

#: Kernel launches, by pass: ``screen`` (every call with candidates and 1
#: to :data:`MAX_OBJECTIVES` objectives), ``split`` (such a call some of
#: whose tests are longer than :data:`SCREEN_ROWS`) and ``wide`` (a call
#: with candidates and any other objective count): see :func:`passes`.
#: Added to where each kernel is launched.
PASS_LAUNCHES = {"screen": 0, "split": 0, "wide": 0}

#: The largest objective count the screen and split kernels take
#: (``kMaxObjectives`` in the source); more, and none, go to the wide
#: kernel.
MAX_OBJECTIVES = 8

#: The most objectives whose bounds the wide kernel stages in shared
#: memory (``kWideStage`` in the source); it reads more from global memory.
WIDE_STAGE = 64

#: The most rows the screen pass tests a candidate against
#: (``kScreenRows`` in the source).
SCREEN_ROWS = 1024

#: The int32 counters at the head of the passes' scratch.
COUNTERS = 3


def passes(n: int, c: int, seg: int = 0, k: int = 1) -> tuple[str, ...]:
    """The kernels one call of :func:`pareto_dominated_cuda` launches for
    ``n`` rows, ``c`` candidates, ``seg`` and ``k`` objectives: none
    without candidates; the wide kernel alone for ``k`` outside 1 to
    :data:`MAX_OBJECTIVES`; else the screen alone where every candidate's
    test (``n`` rows, or its block of ``min(seg, n)``) is at most
    :data:`SCREEN_ROWS` rows, and the screen then the split otherwise."""
    if c == 0:
        return ()
    if not 1 <= k <= MAX_OBJECTIVES:
        return ("wide",)
    longest = min(seg, n) if seg else n
    return ("screen", "split") if longest > SCREEN_ROWS else ("screen",)


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build_library("pareto_dominated"))


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` (a build of ``csrc/pareto_dominated.cu`` or
    of a variant of its text with the same C interface), loaded, typed and
    checked to agree with this binding's constants."""
    lib = ctypes.CDLL(str(path))
    operands = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
    lib.pareto_dominated_screen.argtypes = operands + [ctypes.c_void_p]
    lib.pareto_dominated_split.argtypes = operands + [ctypes.c_void_p] * 2
    lib.pareto_dominated_screen.restype = ctypes.c_int
    lib.pareto_dominated_wide.argtypes = operands[:-2] + [ctypes.c_void_p] * 2
    lib.pareto_dominated_split.restype = ctypes.c_int
    lib.pareto_dominated_wide.restype = ctypes.c_int
    lib.pareto_dominated_max_objectives.restype = ctypes.c_int
    lib.pareto_dominated_screen_rows.restype = ctypes.c_int
    lib.pareto_dominated_wide_stage.restype = ctypes.c_int
    lib.pareto_dominated_error_string.argtypes = [ctypes.c_int]
    lib.pareto_dominated_error_string.restype = ctypes.c_char_p
    if (lib.pareto_dominated_max_objectives() != MAX_OBJECTIVES
            or lib.pareto_dominated_screen_rows() != SCREEN_ROWS
            or lib.pareto_dominated_wide_stage() != WIDE_STAGE):
        raise RuntimeError("pareto_dominated.cu and its binding disagree "
                           "on the largest objective count, the screen "
                           "pass's rows or the wide kernel's staging")
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pareto_dominated_error_string(err).decode()
        raise RuntimeError(f"pareto_dominated {what} launch failed: CUDA "
                           f"error {err} ({msg})")


def pareto_dominated_cuda(rows: torch.Tensor, cands: torch.Tensor,
                          eps: float, seg: int = 0,
                          stats: dict | None = None) -> torch.Tensor:
    """rows (n, k) and cands (c, k) float64, contiguous on one CUDA device
    -> dominated (c,) bool on the card: entry i is True iff some row r has
    ``r[d] <= cands[i, d] + eps`` for every d and ``r[d] < cands[i, d] -
    eps`` for some d.  ``seg > 0`` tests candidate i only against rows
    ``[i // seg * seg, i // seg * seg + seg)`` and needs n == c.

    ``stats``, where given, receives ``"survivors"``: a (1,) int32 tensor on
    the card, the candidates the screen pass left to the split pass (0
    where no split pass ran), and ``"events"``: three CUDA events recorded
    on the stream before the screen, between the passes and after the
    split, whose ``elapsed_time`` gives each pass's time.  Read both after
    the call's work is done.  The wide kernel (``k`` outside 1 to
    :data:`MAX_OBJECTIVES`) fills no ``stats``."""
    for name, t in (("rows", rows), ("cands", cands)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be (count, k), got "
                             f"{tuple(t.shape)}")
    (n, k), c = rows.shape, cands.shape[0]
    if cands.shape[1] != k:
        raise ValueError(f"rows have {k} objectives, cands "
                         f"{cands.shape[1]}")
    if seg < 0:
        raise ValueError(f"seg must be >= 0, got {seg}")
    if seg and n != c:
        raise ValueError(f"seg > 0 tests each candidate against its own "
                         f"block of rows: needs as many rows as "
                         f"candidates, got {n} and {c}")
    for name, t in (("rows", rows), ("cands", cands)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cands.device != rows.device:
        raise ValueError(f"cands on {cands.device}, rows on {rows.device}")
    if max(n, c) > 2 ** 31 - 1:
        raise ValueError(f"the kernel takes at most 2^31 - 1 rows and "
                         f"candidates, got {n} and {c}")
    out = torch.empty(c, dtype=torch.bool, device=cands.device)
    todo = passes(n, c, seg, k)
    if not todo:
        return out
    if todo == ("wide",):
        _wide(rows, cands, k, eps, seg, out)
        LAUNCHES["seg" if seg else "all"] += 1
        return out
    # int32: [survivor count, split work counter, screen queue], then,
    # where a split pass runs, the survivors (c) and their done flags (c
    # bytes)
    split = "split" in todo
    scratch = torch.zeros(COUNTERS + (c + -(-c // 4) if split else 0),
                          dtype=torch.int32, device=cands.device)
    count = scratch.data_ptr()
    survivors = count + 4 * COUNTERS
    done = survivors + 4 * c
    lib = _lib()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(3 if stats is not None else 0)]
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        args = (rows.data_ptr(), n, cands.data_ptr(), c, k, float(eps), seg,
                out.data_ptr())
        if events:
            events[0].record()
        _raise_on(lib, lib.pareto_dominated_screen(
            *args, survivors if split else None, count, stream), "screen")
        PASS_LAUNCHES["screen"] += 1
        if events:
            events[1].record()
        if split:
            _raise_on(lib, lib.pareto_dominated_split(
                *args, survivors, count, done, stream),
                "split")
            PASS_LAUNCHES["split"] += 1
        if events:
            events[2].record()
    LAUNCHES["seg" if seg else "all"] += 1
    if stats is not None:
        stats.update(survivors=scratch[:1], events=events)
    return out


def _wide(rows, cands, k, eps, seg, out) -> None:
    """The wide kernel into ``out``: one launch on torch's current stream,
    its queue (one int64) zeroed on the card."""
    (n, c), lib = (rows.shape[0], cands.shape[0]), _lib()
    queue = torch.zeros(1, dtype=torch.int64, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        _raise_on(lib, lib.pareto_dominated_wide(
            rows.data_ptr(), n, cands.data_ptr(), c, k, float(eps), seg,
            out.data_ptr(), queue.data_ptr(), stream), "wide")
    PASS_LAUNCHES["wide"] += 1
