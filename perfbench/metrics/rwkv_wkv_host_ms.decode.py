"""The host's time in the WKV recurrence (the `rwkv.wkv` spans, nested in
the time-mix), summed per traced decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "rwkv.wkv")
