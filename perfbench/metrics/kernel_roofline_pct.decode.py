"""The least time the card needs for the traced decode steps (per step the
larger of its needed FLOPs at the bf16 dense peak and its needed bytes at
the HBM peak, ``counts/<family>.py``) over their device-busy time."""

from perfbench.lib.trace import steps_of, union_ns


def read(rec):
    tr, peak = rec.get("trace"), rec.get("peaks")
    if not tr or not peak:
        return None
    need, busy = 0.0, 0
    for ev, t0, t1, ops in steps_of(tr):
        if ev["kind"] != "decode":
            continue
        need += max(ev["flops"] / peak["bf16_dense_flops_per_s"],
                    ev["bytes"] / peak["hbm_bytes_per_s"])
        busy += union_ns([(s, e) for _, s, e, _ in ops], t0, t1)
    return 100.0 * need / (busy / 1e9) if busy else None
