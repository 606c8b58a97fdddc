"""The share of the traced decode steps' ``moe.route`` spans whose slot
assignment ran the CUDA kernel (tagged ``kernel`` True), in %.  None where
no step has a ``moe.route`` span or one lacks the tag (a program that does
not tag it)."""

from perfbench.lib.program_spans import decode_steps


def read(rec):
    tags = [t for *_, sp in (decode_steps(rec) or []) for n, _, _, t in sp
            if n == "moe.route"]
    if not tags or any("kernel" not in t for t in tags):
        return None
    return 100.0 * sum(bool(t["kernel"]) for t in tags) / len(tags)
