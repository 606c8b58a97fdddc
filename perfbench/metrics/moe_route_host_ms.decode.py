"""The host's time in the MoE routing (the `moe.route` spans: the router
matmul and softmax through the capacity slot assignment), summed per
traced decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "moe.route")
