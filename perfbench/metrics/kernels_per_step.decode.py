"""Device kernels per traced decode step (the decode call, the argmax and
the tokens' copy)."""

from perfbench.lib.trace import steps_of


def read(rec):
    tr = rec.get("trace")
    steps = [ops for ev, _, _, ops in steps_of(tr)
             if ev["kind"] == "decode"] if tr else []
    if not steps:
        return None
    return sum(sum(op[3] == "kernel" for op in ops) for ops in steps) \
        / len(steps)
