"""The share of the traced decode steps' device time spent in matrix
product kernels (``kernel_classes.json``)."""

from perfbench.lib.trace import steps_of


def read(rec):
    tr = rec.get("trace")
    ops = [op for ev, _, _, o in steps_of(tr) if ev["kind"] == "decode"
           for op in o] if tr else []
    total = sum(e - s for _, s, e, _ in ops)
    if not total:
        return None
    names = rec["matmul_substrings"]
    mm = sum(e - s for n, s, e, _ in ops
             if any(k in n.lower() for k in names))
    return 100.0 * mm / total
