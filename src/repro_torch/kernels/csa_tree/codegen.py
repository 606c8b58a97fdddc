"""Generate the register kernel of the adder-tree schedule for one row count.

The CUDA template ``csrc/csa_tree_reg.cu.in`` holds the kernel around a
body that this module writes from ``build_schedule(rows,
use_compressors).ops``: lane slot s is the local ``l<s>``, the ``rows``
loads come first, then one statement per op, in program order::

    uint32_t l0 = row<kRagged>(p, 0, n, rows_left);
    ...
    fa(l0, l1, l2);        // FA x y z
    fa(l0, l3, 0u);        // FA x y ZERO
    add(l0, l4);           // ADD x y
    return l0;             // the schedule's result slot

so the kernel executes the schedule op for op, as the TPU kernel unrolls
it at trace time.  :func:`read_back` parses those statements out of a
generated source, which lets the CPU tests hold the text the card compiles
against the schedule.  Sources are built at first use by
:func:`repro_torch.kernels.build.build_source`; none is committed.
"""

from __future__ import annotations

import re

import numpy as np

from ..build import CSRC
from ..tiles import CSA_REG_ROWS, CSA_THREADS
from .ref import ADD, FA, ZERO, build_schedule

#: The template the body is written into.
TEMPLATE = CSRC / "csa_tree_reg.cu.in"

_LOAD = re.compile(r"^\s*uint32_t l(\d+) = row<kRagged>\(p, (\d+), n, "
                   r"rows_left\);$")
_FA = re.compile(r"^\s*fa\(l(\d+), l(\d+), (?:l(\d+)|0u)\);$")
_ADD = re.compile(r"^\s*add\(l(\d+), l(\d+)\);$")
_RESULT = re.compile(r"^\s*return l(\d+);$")


def library_name(rows: int, use_compressors: bool) -> str:
    """The build name of the kernel for ``rows`` rows."""
    return f"csa_tree_reg_r{rows}_{'c42' if use_compressors else 'fa'}"


def body(rows: int, use_compressors: bool = True) -> str:
    """The straight-line statements of the ``rows``-row schedule."""
    sched = build_schedule(rows, use_compressors)
    lines = [f"  uint32_t l{r} = row<kRagged>(p, {r}, n, rows_left);"
             for r in range(rows)]
    for kind, x, y, z in sched.ops.tolist():
        if kind == FA:
            zs = "0u" if z == ZERO else f"l{z}"
            lines.append(f"  fa(l{x}, l{y}, {zs});")
        else:
            lines.append(f"  add(l{x}, l{y});")
    lines.append(f"  return l{sched.result};")
    return "\n".join(lines)


def source(rows: int, use_compressors: bool = True) -> str:
    """The whole CUDA source of the ``rows``-row register kernel."""
    if not 1 <= rows <= CSA_REG_ROWS:
        raise ValueError(f"the register kernel holds 1..{CSA_REG_ROWS} rows "
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
    program its statements execute, an (n_ops, 4) int32 array in
    ``build_schedule``'s encoding; the result slot)."""
    loads, ops, result = [], [], None
    for line in text.splitlines():
        if m := _LOAD.match(line):
            if m[1] != m[2]:
                raise ValueError(f"row {m[2]} loads into slot {m[1]}")
            loads.append(int(m[1]))
        elif m := _FA.match(line):
            ops.append((FA, int(m[1]), int(m[2]),
                        ZERO if m[3] is None else int(m[3])))
        elif m := _ADD.match(line):
            ops.append((ADD, int(m[1]), int(m[2]), 0))
        elif m := _RESULT.match(line):
            if result is not None:
                raise ValueError("two result statements")
            result = int(m[1])
    if result is None:
        raise ValueError("no result statement")
    return loads, np.asarray(ops, np.int32).reshape(-1, 4), result
