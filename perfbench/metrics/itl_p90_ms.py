"""The 90th percentile (nearest rank) of every inter-token gap of every
request in the window.  The sequences of one step share its gap, so each
step's gap counts once per sequence; a job's first token (its prefill) is
no gap."""


def read(rec):
    gaps = sorted((e["gap_ns"], e["tokens"]) for e in rec["events"]
                  if e["kind"] == "decode")
    if not gaps:
        return None
    total = sum(n for _, n in gaps)
    seen = 0
    for gap, n in gaps:
        seen += n
        if seen >= 0.9 * total:
            return gap / 1e6
