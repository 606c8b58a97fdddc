"""The share of a decode step's time in which no operation runs on the
device: 100 less a traced decode step's device-busy time (the union of
its device ops) over the window's mean decode step (token to token).  The
step's time is the untraced window's: the profiler's CPU activity slows
the host's dispatch of a traced step, which would read as idle time."""

from perfbench.lib.trace import steps_of, union_ns


def read(rec):
    tr = rec.get("trace")
    steps = [e for e in rec["events"] if e["kind"] == "decode"]
    busy = [union_ns([(s, e) for _, s, e, _ in ops], t0, t1)
            for ev, t0, t1, ops in (steps_of(tr) if tr else [])
            if ev["kind"] == "decode"]
    if not steps or not busy:
        return None
    step_ns = sum(e["gap_ns"] for e in steps) / len(steps)
    return 100.0 * (1 - sum(busy) / len(busy) / step_ns)
