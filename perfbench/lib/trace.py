"""The traced steps of a ``--trace 1`` run and their reduction.

After the measured window has closed, the run traces a few more whole
steps of the same job with ``torch.profiler`` (CPU and CUDA activities):
one step to warm the profiler, then ``trace_steps`` steps.  The loop's own
spans (``prefill``, ``decode_call``, ``argmax``, ``token_copy``) are
``record_function`` ranges in the same trace, so the device's operations
and the host's spans share one clock.  The traced window runs from the
first traced step's call to its last step's tokens on the host.

The reduction keeps the device's operations (kernels, copies, sets) that
start inside the window; the metric readers take their counts, union and
gaps from it.
"""

from __future__ import annotations

LABELS = ("prefill", "decode_call", "argmax", "token_copy")


def _kind(e) -> str | None:
    """``kernel``, ``memcpy``, ``memset`` or None (not a device op)."""
    if str(e.device_type()).split(".")[-1] != "CUDA":
        return None
    if e.is_user_annotation():
        return None
    act = getattr(e, "activity_type", None)
    if act is not None:
        act = str(act()).lower()
        if "annotation" in act:
            return None
        if "memcpy" in act:
            return "memcpy"
        if "memset" in act:
            return "memset"
        return "kernel" if "kernel" in act else None
    name = e.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return None if "Sync" in name else "kernel"


def trace_steps(pool, n: int) -> dict:
    """Run one warm step and ``n`` traced steps of ``pool`` under the
    profiler; return the reduced trace (module doc)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pool.step(spans=True)
        events = [pool.step(spans=True) for _ in range(n)]
    raw = prof.profiler.kineto_results.events()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in raw
                    if e.is_user_annotation() and e.name() in LABELS
                    and str(e.device_type()).split(".")[-1] == "CPU"),
                   key=lambda s: s[1])
    traced = spans[-3 * n:]          # three spans per step (pool.step)
    w0, w1 = traced[0][1], traced[-1][2]
    ops = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   k) for e in raw if (k := _kind(e)) is not None
                  and w0 <= e.start_ns() < w1), key=lambda op: op[1])
    return {"window_ns": [w0, w1], "spans": traced, "ops": ops,
            "events": events}


def steps_of(tr: dict) -> list:
    """``[(event, t0, t1, ops)]`` per traced step: its three spans' extent
    and the device ops that start inside it."""
    out = []
    spans = tr["spans"]
    for i, ev in enumerate(tr["events"]):
        t0, t1 = spans[3 * i][1], spans[3 * i + 2][2]
        out.append((ev, t0, t1, [op for op in tr["ops"]
                                 if t0 <= op[1] < t1]))
    return out


def union_ns(intervals, w0: int, w1: int) -> int:
    """The length of the union of ``(start, end)`` intervals, clipped to
    ``[w0, w1]``."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_ns(tr: dict) -> int:
    w0, w1 = tr["window_ns"]
    return union_ns([(s, e) for _, s, e, _ in tr["ops"]], w0, w1)


def idle_gaps(tr: dict) -> list:
    """``[(label, start, length)]`` of every gap between device ops inside
    the window, labelled by the host span its start fell in
    (``between_calls`` outside every span)."""
    w0, w1 = tr["window_ns"]
    gaps, t = [], w0
    for _, s, e, _ in tr["ops"]:
        if s > t:
            gaps.append((t, s - t))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1 - t))
    out = []
    for start, length in gaps:
        label = "between_calls"
        for name, s, e in tr["spans"]:
            if s <= start < e:
                label = name
                break
        out.append((label, start, length))
    return out


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device ops that took most time (summed by name) and the longest
    idle gaps by what the host was doing, in seconds."""
    by_name: dict[str, int] = {}
    for name, s, e, _ in tr["ops"]:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(tr), key=lambda g: -g[2])[:top]
    return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
            "idle_gaps": [[label, length / 1e9] for label, _, length in gaps]}
