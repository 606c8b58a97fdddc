"""The host's time in the attention (the `attn` spans: projections, rope,
the KV-cache write and the attention over the cache), summed per traced
decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "attn")
