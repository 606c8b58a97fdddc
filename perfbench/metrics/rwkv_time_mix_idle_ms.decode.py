"""The device's idle time while the host is inside the Finch time-mix: a
traced decode step's idle time (its extent less its device ops) within
its `rwkv.time_mix` spans, mean over the steps."""

from perfbench.lib.program_spans import idle_ms


def read(rec):
    return idle_ms(rec, "rwkv.time_mix")
