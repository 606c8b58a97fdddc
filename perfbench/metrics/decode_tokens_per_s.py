"""Every token of the decode steps completed inside the window, over the
window's seconds."""


def read(rec):
    steps = [e for e in rec["events"] if e["kind"] == "decode"]
    if not steps:
        return None
    return sum(e["tokens"] for e in steps) / rec["window_s"]
