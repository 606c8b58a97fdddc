"""Generate the register kernel of the adder-tree schedule for one row count.

The CUDA template ``csrc/csa_tree_reg.cu.in`` holds the kernel around a
body that this module writes from ``build_schedule(rows,
use_compressors).ops``: lane slot s is the local ``l<s>``, each row is
loaded into its slot, and each op is one statement::

    uint32_t l0 = row<kRagged>(p, 0, n, rows_left);
    ...
    fa(l0, l1, l2);        // FA x y z
    fa(l0, l3, 0u);        // FA x y ZERO
    add(l0, l4);           // ADD x y
    return l0;             // the schedule's result slot

so the kernel executes the schedule op for op, as the TPU kernel unrolls
it at trace time.

Order.  The schedule lists its ops level by level, and in that order
ptxas issues the row loads ahead of the tree as far as registers allow,
which is what keeps a narrow stack's loads in flight.  But a level's
outputs (half the lanes) are all live before the next level starts: 257
lanes at 512 rows, past the 255 registers of a thread.  So the body runs
the same ops in *window order* (:func:`window_order`): the rows are cut
into windows of w rows, the ops that need only rows up to the end of a
window run, in the schedule's order, before any op that needs a later row,
and each row is loaded w rows ahead of the first op that reads it.  The
window (:func:`window`) is the largest of the whole stack, 256, 128 and
64 rows that keeps at most :data:`TREE_LANES` lanes live: every stack of
at most 128 rows, and the 4-2 compressor schedule up to 318 rows, runs in
the schedule's own order.  Ops that share a slot keep their schedule
order, so every op reads the same values as in the schedule and the
result is the same bits.

:func:`read_back` parses the statements out of a generated source, which
lets the CPU tests hold the text the card compiles against the schedule.
Sources are built at first use by :func:`repro_torch.kernels.build.
build_source`; none is committed.
"""

from __future__ import annotations

import re

import numpy as np

from ..build import CSRC
from ..tiles import CSA_MAX_ROWS, CSA_THREADS
from .ref import ADD, FA, ZERO, Schedule, build_schedule

#: The template the body is written into.
TEMPLATE = CSRC / "csa_tree_reg.cu.in"

#: Lanes the tree may hold live at once: the rest of a thread's 255
#: registers keep row loads in flight.  On an H100, 256-row windows that
#: hold 171-185 lanes (the full-adder schedule at 256-512 rows) took all
#: 255 registers, 128-row ones 128-172, and were as fast or faster
#: (``probes/csa_tall.py``).
TREE_LANES = 160

#: Window heights tried, largest first, after the whole stack.
WINDOWS = (256, 128, 64)

_LOAD = re.compile(r"^\s*uint32_t l(\d+) = row<kRagged>\(p, (\d+), n, "
                   r"rows_left\);$")
_FA = re.compile(r"^\s*fa\(l(\d+), l(\d+), (?:l(\d+)|0u)\);$")
_ADD = re.compile(r"^\s*add\(l(\d+), l(\d+)\);$")
_RESULT = re.compile(r"^\s*return l(\d+);$")


def library_name(rows: int, use_compressors: bool) -> str:
    """The build name of the kernel for ``rows`` rows."""
    return f"csa_tree_reg_r{rows}_{'c42' if use_compressors else 'fa'}"


def _slots(op) -> tuple[int, ...]:
    kind, x, y, z = op
    return (x, y, z) if kind == FA and z != ZERO else (x, y)


def window_order(sched: Schedule, window: int) -> list[int]:
    """The indices of ``sched.ops`` in the order the body runs them: by the
    window of the last row each op needs (through the ops before it on its
    slots), then in schedule order.  Ops that share a slot keep their
    order, since the later one needs every row the earlier one needs."""
    ops = sched.ops.tolist()
    last: dict[int, int] = {}
    needs = []
    for i, op in enumerate(ops):
        needs.append(max(needs[last[s]] if s in last else s
                         for s in _slots(op)))
        for s in _slots(op):
            last[s] = i
    return sorted(range(len(ops)), key=lambda i: (needs[i] // window, i))


def live_lanes(sched: Schedule, order: list[int]) -> int:
    """The most lanes held at once when the ops run in ``order``: a lane is
    live from the first op that reads it to the last (the result to the
    end)."""
    first: dict[int, int] = {}
    last: dict[int, int] = {}
    for pos, i in enumerate(order):
        for s in _slots(sched.ops[i].tolist()):
            first.setdefault(s, pos)
            last[s] = pos
    end = len(order)
    first.setdefault(sched.result, end)
    last[sched.result] = end
    delta = np.zeros(end + 2, np.int64)
    for s, pos in first.items():
        delta[pos] += 1
        delta[last[s] + 1] -= 1
    return int(np.cumsum(delta).max())


def window(rows: int, use_compressors: bool = True) -> int:
    """The window of the ``rows``-row kernel: the largest of ``rows`` and
    :data:`WINDOWS` whose order holds at most :data:`TREE_LANES` lanes."""
    sched = build_schedule(rows, use_compressors)
    for w in (rows, *WINDOWS):
        if w <= rows and live_lanes(sched, window_order(sched, w)) \
                <= TREE_LANES:
            return w
    return WINDOWS[-1]


def body(rows: int, use_compressors: bool = True) -> str:
    """The straight-line statements of the ``rows``-row schedule in window
    order (:func:`window`), each row loaded a window ahead of its first
    reader."""
    w = window(rows, use_compressors)
    sched = build_schedule(rows, use_compressors)
    lines: list[str] = []
    loaded = 0

    def load_through(row: int) -> None:
        nonlocal loaded
        for r in range(loaded, min(rows, row + 1)):
            lines.append(f"  uint32_t l{r} = row<kRagged>(p, {r}, n, "
                         f"rows_left);")
        loaded = max(loaded, min(rows, row + 1))

    for i in window_order(sched, w):
        kind, x, y, z = sched.ops[i].tolist()
        needed = max(_slots((kind, x, y, z)))
        if needed >= loaded:
            load_through(needed + w)
        if kind == FA:
            zs = "0u" if z == ZERO else f"l{z}"
            lines.append(f"  fa(l{x}, l{y}, {zs});")
        else:
            lines.append(f"  add(l{x}, l{y});")
    load_through(rows - 1)
    lines.append(f"  return l{sched.result};")
    return "\n".join(lines)


def source(rows: int, use_compressors: bool = True) -> str:
    """The whole CUDA source of the ``rows``-row register kernel."""
    if not 1 <= rows <= CSA_MAX_ROWS:
        raise ValueError(f"the register kernel holds 1..{CSA_MAX_ROWS} rows "
                         f"in registers, got {rows}")
    text = TEMPLATE.read_text()
    if text.count("@BODY@") != 1:
        raise ValueError(f"{TEMPLATE} must hold the body marker once")
    for key, value in (("@ROWS@", str(rows)), ("@THREADS@", str(CSA_THREADS)),
                       ("@BODY@", body(rows, use_compressors))):
        text = text.replace(key, value)
    return text


def read_back(text: str) -> tuple[list[int], np.ndarray, int]:
    """Parse a generated source: (the rows its loads read, in order; the op
    program its statements execute, in the order they run, an (n_ops, 4)
    int32 array in ``build_schedule``'s encoding; the result slot).
    Raises if a statement reads a slot before its row is loaded."""
    loads, ops, result = [], [], None
    for line in text.splitlines():
        if m := _LOAD.match(line):
            if m[1] != m[2]:
                raise ValueError(f"row {m[2]} loads into slot {m[1]}")
            loads.append(int(m[1]))
            continue
        if m := _FA.match(line):
            ops.append((FA, int(m[1]), int(m[2]),
                        ZERO if m[3] is None else int(m[3])))
            reads = _slots(ops[-1])
        elif m := _ADD.match(line):
            ops.append((ADD, int(m[1]), int(m[2]), 0))
            reads = _slots(ops[-1])
        elif m := _RESULT.match(line):
            if result is not None:
                raise ValueError("two result statements")
            result = int(m[1])
            reads = (result,)
        else:
            continue
        if unloaded := set(reads) - set(loads):
            raise ValueError(f"{line.strip()!r} reads slots {sorted(unloaded)} "
                             f"before their rows are loaded")
    if result is None:
        raise ValueError("no result statement")
    return loads, np.asarray(ops, np.int32).reshape(-1, 4), result
