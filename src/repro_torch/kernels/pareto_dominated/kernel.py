"""ctypes binding of the CUDA eps-band dominance kernel
(``csrc/pareto_dominated.cu``), rows A2 and A3 of the kernel table.

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process (:func:`bind` loads a build of
a variant of its text the same way).  :func:`pareto_dominated_cuda`
checks its operands, allocates the verdicts with ``torch.empty`` and the
passes' scratch (counters, the survivor list and its done flags) with
``torch.zeros`` on the operands' device,
launches the screen pass and, where some candidate's test is longer than
the screen's rows (:func:`screen_rows`), the split pass on torch's current
stream without synchronising (the split pass reads the survivor count on
the device): for 1 to :data:`MAX_OBJECTIVES` objectives the kernels of that
count, for any other count (more objectives, or none) the wide ones, which
take the count at run time (with none, the wide screen alone answers
False).  It raises if a launch was refused, and counts: one in
:data:`LAUNCHES` under its mode per call, one in :data:`PASS_LAUNCHES` per
kernel launched.  It takes CUDA tensors only: the dispatcher
:func:`repro_torch.core.pareto.dominated` runs the plain version for CPU
tensors.
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
#: whose tests are longer than the screen's rows), and ``wide_screen`` /
#: ``wide_split`` the same for any other objective count (``wide_split``
#: never at none): see :func:`passes`.  Added to where each kernel is
#: launched.
PASS_LAUNCHES = {"screen": 0, "split": 0, "wide_screen": 0, "wide_split": 0}

#: The largest objective count the screen and split kernels take
#: (``kMaxObjectives`` in the source); more, and none, go to the wide
#: kernels.
MAX_OBJECTIVES = 8

#: The most objectives the wide kernels stage in shared memory, the rows
#: and the candidates' bounds (``kWideStage`` in the source); they read
#: more in place, from global memory.
WIDE_STAGE = 64

#: The most rows the screen pass tests a candidate against
#: (``kScreenRows`` in the source).
SCREEN_ROWS = 1024

#: The float64 values of shared memory the wide screen's stream and its
#: warps' bounds may take, its warps, and the candidates a warp tests
#: together (``kWideScreenValues``, ``kWideScreenWarps``, ``kWideGroup``).
WIDE_SCREEN_VALUES, WIDE_SCREEN_WARPS, WIDE_GROUP = 28672, 16, 2

#: The int32 counters at the head of the passes' scratch.
COUNTERS = 3


def screen_rows(k: int) -> int:
    """The most rows the screen pass tests a candidate against for ``k``
    objectives: :data:`SCREEN_ROWS`, but for the wide screen's stream
    staged in shared memory (``wide_screen_rows`` in the source): up to
    :data:`WIDE_STAGE` objectives, as many whole warps of rows as
    :data:`WIDE_SCREEN_VALUES` hold beside its warps' bounds, at most
    :data:`SCREEN_ROWS`."""
    if k <= MAX_OBJECTIVES or k > WIDE_STAGE:
        return SCREEN_ROWS
    rows = (WIDE_SCREEN_VALUES // k - 1
            - 2 * WIDE_GROUP * WIDE_SCREEN_WARPS) // 32 * 32
    return min(rows, SCREEN_ROWS)


def passes(n: int, c: int, seg: int = 0, k: int = 1) -> tuple[str, ...]:
    """The kernels one call of :func:`pareto_dominated_cuda` launches for
    ``n`` rows, ``c`` candidates, ``seg`` and ``k`` objectives: none
    without candidates; else the screen alone where every candidate's test
    (``n`` rows, or its block of ``min(seg, n)``) is at most
    ``screen_rows(k)`` rows or ``k`` is 0, and the screen then the split
    otherwise; the wide ones (``wide_screen``, ``wide_split``) for ``k``
    outside 1 to :data:`MAX_OBJECTIVES`."""
    if c == 0:
        return ()
    wide = "wide_" if not 1 <= k <= MAX_OBJECTIVES else ""
    longest = min(seg, n) if seg else n
    if longest > screen_rows(k) and k > 0:
        return (wide + "screen", wide + "split")
    return (wide + "screen",)


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
    for prefix in ("pareto_dominated_", "pareto_dominated_wide_"):
        screen = getattr(lib, prefix + "screen")
        split = getattr(lib, prefix + "split")
        screen.argtypes = operands + [ctypes.c_void_p]
        split.argtypes = operands + [ctypes.c_void_p] * 2
        screen.restype = split.restype = ctypes.c_int
    lib.pareto_dominated_max_objectives.restype = ctypes.c_int
    lib.pareto_dominated_screen_rows.restype = ctypes.c_int
    lib.pareto_dominated_wide_stage.restype = ctypes.c_int
    lib.pareto_dominated_wide_screen_rows.argtypes = [ctypes.c_int]
    lib.pareto_dominated_wide_screen_rows.restype = ctypes.c_int
    lib.pareto_dominated_error_string.argtypes = [ctypes.c_int]
    lib.pareto_dominated_error_string.restype = ctypes.c_char_p
    if (lib.pareto_dominated_max_objectives() != MAX_OBJECTIVES
            or lib.pareto_dominated_screen_rows() != SCREEN_ROWS
            or lib.pareto_dominated_wide_stage() != WIDE_STAGE
            or any(lib.pareto_dominated_wide_screen_rows(k) != screen_rows(k)
                   for k in range(MAX_OBJECTIVES + 1, 2 * WIDE_STAGE))):
        raise RuntimeError("pareto_dominated.cu and its binding disagree "
                           "on the largest objective count, the screen "
                           "pass's rows or the wide kernels' staging")
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
    the call's work is done.  The wide kernels (``k`` outside 1 to
    :data:`MAX_OBJECTIVES`) fill them the same way."""
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
    # int32: [survivor count, split work counter, screen queue], then,
    # where a split pass runs, the survivors (c) and their done flags (c
    # bytes)
    split = len(todo) > 1
    scratch = torch.zeros(COUNTERS + (c + -(-c // 4) if split else 0),
                          dtype=torch.int32, device=cands.device)
    count = scratch.data_ptr()
    survivors = count + 4 * COUNTERS
    done = survivors + 4 * c
    lib = _lib()
    # each pass's C entry point is named after it
    launch = {name: getattr(lib, f"pareto_dominated_{name}") for name in todo}
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(3 if stats is not None else 0)]
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        args = (rows.data_ptr(), n, cands.data_ptr(), c, k, float(eps), seg,
                out.data_ptr())
        if events:
            events[0].record()
        _raise_on(lib, launch[todo[0]](
            *args, survivors if split else None, count, stream), todo[0])
        PASS_LAUNCHES[todo[0]] += 1
        if events:
            events[1].record()
        if split:
            _raise_on(lib, launch[todo[1]](*args, survivors, count, done,
                                           stream), todo[1])
            PASS_LAUNCHES[todo[1]] += 1
        if events:
            events[2].record()
    LAUNCHES["seg" if seg else "all"] += 1
    if stats is not None:
        stats.update(survivors=scratch[:1], events=events)
    return out

