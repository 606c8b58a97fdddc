"""The share of MoE assignments that found no capacity slot: 100 x
(routed - kept) / routed, summed over the traced decode steps' `moe.route`
spans."""

from perfbench.lib.program_spans import moe_counts


def read(rec):
    counts = moe_counts(rec)
    if counts is None:
        return None
    routed, _, kept = counts
    return 100.0 * (routed - kept) / routed
