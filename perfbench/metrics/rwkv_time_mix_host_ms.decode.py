"""The host's time in the Finch time-mix (the `rwkv.time_mix` spans, the
WKV recurrence inside them included), summed per traced decode step,
mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "rwkv.time_mix")
