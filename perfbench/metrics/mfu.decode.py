"""The whole decode step's share of the card's bf16 dense peak: the
needed FLOPs of the window's decode steps (``counts/<family>.py``) over
the window's seconds times the peak."""


def read(rec):
    peak = rec.get("peaks")
    steps = [e for e in rec["events"] if e["kind"] == "decode"]
    if not peak or not steps:
        return None
    flops = sum(e["flops"] for e in steps)
    return 100.0 * flops / (rec["window_s"] * peak["bf16_dense_flops_per_s"])
