"""The host's time in the Finch channel-mix (the `rwkv.channel_mix` spans),
summed per traced decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "rwkv.channel_mix")
