"""Span exporter: Chrome ``trace_event`` timelines.

The Chrome format (``{"traceEvents": [...]}`` with complete ``"ph": "X"``
events, plain stdlib json) is what ``launch.serve --dcim-trace PATH``
writes; load it at https://ui.perfetto.dev (or chrome://tracing) to see
each request's queued→batched→served lane with cache-tier and engine-pass
child spans, and each serving step's lane with its layers' spans.

Chrome events use microsecond timestamps relative to the earliest span in
the export (the tracer clock is ``time.monotonic``, whose epoch is
arbitrary).  Each trace gets its own ``tid`` lane named after the trace
root, so concurrent requests render as parallel rows instead of one
interleaved smear.
"""

from __future__ import annotations

import json

from .tracing import Span


def chrome_trace_events(spans: list[Span]) -> list[dict]:
    """Convert spans to Chrome ``trace_event`` dicts (complete events).

    One ``tid`` per trace, with ``thread_name`` metadata naming the lane
    after the trace's root span (e.g. ``request[ab12cd34]``)."""
    if not spans:
        return []
    t0 = min(s.start_s for s in spans)
    roots = {s.trace_id: s for s in spans if s.parent_id is None}
    tids: dict[str, int] = {}
    events: list[dict] = []
    for s in spans:
        tid = tids.get(s.trace_id)
        if tid is None:
            tid = tids[s.trace_id] = len(tids) + 1
            root = roots.get(s.trace_id)
            label = (f"{root.name}[{s.trace_id[:8]}]" if root is not None
                     else f"trace[{s.trace_id[:8]}]")
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": label}})
        end_s = s.end_s if s.end_s is not None else s.start_s
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update(s.tags)
        events.append({
            "ph": "X", "name": s.name, "pid": 1, "tid": tid,
            "ts": (s.start_s - t0) * 1e6,
            "dur": max(end_s - s.start_s, 0.0) * 1e6,
            "cat": s.name.split(".", 1)[0],
            "args": args,
        })
    return events


def write_chrome_trace(spans: list[Span], path) -> int:
    """Write a Perfetto/chrome-tracing loadable JSON; returns the number
    of span events written (metadata events excluded)."""
    events = chrome_trace_events(spans)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, fh)
    return sum(1 for e in events if e["ph"] == "X")
