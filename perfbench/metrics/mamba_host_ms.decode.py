"""The host's time in the Mamba2 blocks (the `mamba` spans), summed per
traced decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "mamba")
