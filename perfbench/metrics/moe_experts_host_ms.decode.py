"""The host's time in the MoE experts (the `moe.experts` spans: the
dispatch einsum, the experts' fake-quant and einsums, the combine einsum),
summed per traced decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "moe.experts")
