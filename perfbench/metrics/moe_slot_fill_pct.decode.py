"""The share of the experts' capacity slots that hold a token: 100 x kept /
slots, summed over the traced decode steps' `moe.route` spans (the expert
einsums compute every slot)."""

from perfbench.lib.program_spans import moe_counts


def read(rec):
    counts = moe_counts(rec)
    if counts is None:
        return None
    _, slots, kept = counts
    return 100.0 * kept / slots
