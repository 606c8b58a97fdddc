"""Plain versions of the carry-save adder-tree kernel, and its schedule.

``csa_tree_ref`` is the plain column sum the kernel is held against.  The
schedule is what the kernel executes: :func:`build_schedule` turns a row
count into a small op program that follows the JAX package's
``_reduce_level``/``_reduce_lanes`` (``repro/kernels/csa_tree/kernel.py``)
lane for lane, and :func:`reduce_levels` runs the same program in torch,
so a test can hold the program the CUDA kernel runs against the reference
schedule level by level.

Program: one lane value per *slot*; the H input rows start in slots
0..H-1.  Each op is four int32 ``(kind, x, y, z)``:

  ``FA``   full adder on slots x, y, z (z = ``ZERO`` reads 0):
           slot x <- x ^ y ^ z, slot y <- ((x & y) | (y & z) | (x & z)) << 1
  ``ADD``  slot x <- x + y (the force-progress add and the final ripple add)

Outputs overwrite input slots, so the program never needs more than H
slots.  A 4-2 compressor is two chained full adders (the "5-3 carry-save
adder" of the paper's [11]): FA(a, b, c) leaves its sum in a and its
chained carry-out in b; FA(a, d, cin) leaves the sum in a and the carry in
d.  All arithmetic is on 32-bit two's-complement words and wraps mod 2^32,
as JAX int32 does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FA, ADD = 0, 1

#: Operand index that reads as the constant 0 (the first compressor's cin).
ZERO = -1

_MASK = 0xFFFFFFFF


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 as int32 two's complement."""
    x = x & _MASK
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def csa_tree_ref(operands: torch.Tensor) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 exact column sums, wrapping mod 2^32.

    ``torch.sum`` of int32 returns int64; the sum is taken in int64 (exact
    for H < 2^32) and wrapped back to int32 explicitly."""
    return _wrap_int32(operands.to(torch.int32).sum(0, dtype=torch.int64))


@dataclass(frozen=True)
class Schedule:
    """The op program of the Fig. 4 reduction for one row count.

    ``ops`` is the (n_ops, 4) int32 program; ``levels[i]`` lists the slots
    holding the lanes after tree level i (in order, the force-progress add
    included), and ``level_ends[i]`` the number of ops that complete it;
    the column sum ends in slot ``result``."""

    ops: np.ndarray
    levels: tuple[tuple[int, ...], ...]
    level_ends: tuple[int, ...]
    result: int


def build_schedule(rows: int, use_compressors: bool = True) -> Schedule:
    """The reduction program for ``rows`` lanes (see the module doc)."""
    if rows < 1:
        raise ValueError(f"the adder tree needs at least one row, got {rows}")
    ops: list[tuple[int, int, int, int]] = []
    lanes = list(range(rows))
    levels, ends = [], []
    guard = 0
    while len(lanes) > 2 and guard < 64:
        guard += 1
        nxt, i = [], 0
        if use_compressors:
            cout = None
            while len(lanes) - i >= 4:
                a, b, c, d = lanes[i:i + 4]
                ops.append((FA, a, b, c))                 # s1 -> a, cout -> b
                ops.append((FA, a, d, ZERO if cout is None else cout))
                nxt += [a, d]
                cout = b
                i += 4
            if cout is not None:
                nxt.append(cout)
        while len(lanes) - i >= 3:
            a, b, c = lanes[i:i + 3]
            ops.append((FA, a, b, c))
            nxt += [a, b]
            i += 3
        nxt += lanes[i:]
        if len(nxt) >= len(lanes):                        # force progress
            ops.append((ADD, nxt[0], nxt[1], 0))
            nxt = [nxt[0]] + nxt[2:]
        lanes = nxt
        levels.append(tuple(lanes))
        ends.append(len(ops))
    for lane in lanes[1:]:                                # final ripple add
        ops.append((ADD, lanes[0], lane, 0))
    return Schedule(np.asarray(ops, np.int32).reshape(-1, 4), tuple(levels),
                    tuple(ends), lanes[0])


def _run(slots: torch.Tensor, ops: np.ndarray, start: int, stop: int) -> None:
    """Execute ops[start:stop] on ``slots`` (int64 words in [0, 2^32))."""
    zero = torch.zeros_like(slots[0])
    for kind, x, y, z in ops[start:stop].tolist():
        if kind == FA:
            a, b = slots[x], slots[y]
            c = zero if z == ZERO else slots[z]
            s = a ^ b ^ c
            carry = (((a & b) | (b & c) | (a & c)) << 1) & _MASK
            slots[x], slots[y] = s, carry
        else:
            slots[x] = (slots[x] + slots[y]) & _MASK


def reduce_levels(operands: torch.Tensor, use_compressors: bool = True
                  ) -> list[torch.Tensor]:
    """Run the schedule on (H, N) int32 operands in torch and return the
    lanes after every tree level, each an (n_lanes, N) int32 tensor: the
    plain execution of the program the kernel runs, for the tests."""
    sched = build_schedule(operands.shape[0], use_compressors)
    slots = operands.to(torch.int64) & _MASK
    out, start = [], 0
    for lanes, end in zip(sched.levels, sched.level_ends):
        _run(slots, sched.ops, start, end)
        out.append(_wrap_int32(slots[list(lanes)]))
        start = end
    return out


def reduce_lanes(operands: torch.Tensor, use_compressors: bool = True
                 ) -> torch.Tensor:
    """The whole schedule (tree levels, then the final ripple add) on (H, N)
    int32 operands in torch: (N,) int32, equal to :func:`csa_tree_ref`."""
    sched = build_schedule(operands.shape[0], use_compressors)
    slots = operands.to(torch.int64) & _MASK
    _run(slots, sched.ops, 0, len(sched.ops))
    return _wrap_int32(slots[sched.result])
