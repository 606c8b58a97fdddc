"""The host's time in the decode call, from the call to its return (the
device not synchronised), median over the window's decode steps."""

import statistics


def read(rec):
    ms = [(e["t_ret"] - e["t0"]) / 1e6 for e in rec["events"]
          if e["kind"] == "decode"]
    return statistics.median(ms) if ms else None
