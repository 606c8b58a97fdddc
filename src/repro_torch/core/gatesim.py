"""Functional gate-level simulation of synthesized adder-tree netlists.

The paper validates generated macros through post-synthesis gate-level
simulation (§III-D).  This module plays that role: it *executes* the
structural netlists emitted by :func:`repro_torch.core.csa.build_netlist` on
numpy integer tensors using exact carry-save algebra:

  FA  : (a, b, c)          -> sum = a ^ b ^ c, carry = majority(a,b,c) << 1
  C42 : (a, b, c, d, cin)  -> two chained FAs — the paper's "4-2 compressor as
                              a 5-3 carry-save adder" construction (Fig. 4)
  RCA : final ripple-carry -> exact integer addition

Carry-save invariant: every gate preserves Σ(outputs) == Σ(inputs), so the
tree's final output must equal the integer sum of its operand lanes.  Tests
(and the macro functional-verification step) assert exactly that against
arbitrary signed operands.
"""

from __future__ import annotations

import numpy as np

from .csa import TreeNetlist


def _fa(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    s = a ^ b ^ c
    carry = ((a & b) | (b & c) | (a & c)) << 1
    return s, carry


def _c42(a, b, c, d, cin) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    # First FA compresses (a, b, c); its carry is the stage cout (chained to
    # the neighbor compressor); second FA compresses (s1, d, cin).
    s1, cout = _fa(a, b, c)
    s, carry = _fa(s1, d, cin)
    return s, carry, cout


def simulate(nl: TreeNetlist, operands: np.ndarray) -> np.ndarray:
    """Evaluate the netlist on ``operands`` of shape (n_inputs, ...) int64.

    Returns the tree output (shape ``operands.shape[1:]``).
    """
    if operands.shape[0] != nl.n_inputs:
        raise ValueError(f"netlist expects {nl.n_inputs} operand lanes, "
                         f"got {operands.shape[0]}")
    operands = operands.astype(np.int64)
    wires: dict[str, np.ndarray] = {"zero": np.zeros(operands.shape[1:], np.int64)}
    for i in range(nl.n_inputs):
        wires[f"in{i}"] = operands[i]
    for g in nl.gates:
        ins = [wires[w] for w in g.ins]
        if g.kind == "FA":
            s, c = _fa(*ins)
            wires[g.outs[0]], wires[g.outs[1]] = s, c
        elif g.kind == "C42":
            s, c, co = _c42(*ins)
            wires[g.outs[0]], wires[g.outs[1]], wires[g.outs[2]] = s, c, co
        elif g.kind == "RCA":
            wires[g.outs[0]] = sum(ins)
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown gate kind {g.kind}")
    return wires[nl.outputs[0]]


def verify_tree(nl: TreeNetlist, operands: np.ndarray) -> bool:
    """Carry-save invariant check: netlist output == integer sum of lanes."""
    out = simulate(nl, operands)
    ref = operands.astype(np.int64).sum(axis=0)
    return bool(np.array_equal(out, ref))
