"""Per-cell tuned configurations (the port of the JAX package's
``repro/launch/tuned.py``, the table as it is).  ``--tuned`` dry runs
(:mod:`repro_torch.launch.dryrun`) apply these on top of ``act_shard``,
as the reference's do; no other launcher reads them.

In the port ``act_shard`` and the activation rules below (``act_heads``,
``act_ff``, ``seq``) change nothing: its activations are plain tensors,
never sharded (:func:`repro_torch.parallel.sharding.constrain_act`).  The
``batch`` rules and ``remat`` do act: they set which ranks split the
batch and whether blocks are recomputed.  The table's comments are the
reference's, its measurements taken by the reference on its own hardware.

Keys: (arch, shape, mesh) with None wildcards; first exact match wins.
"""

from __future__ import annotations

# Tiny-width archs (d_model/16 < 128 lanes) suffer degenerate 16-way TP:
# head-padding all-reduces dominate.  Fixes the reference found:
#   * train (global_batch divides the whole mesh): pure data parallelism —
#     batch over every axis, features local, weights still FSDP-sharded.
#   * prefill (batch < ranks): batch over 'data' + sequence-parallel
#     activations over 'model'.
_PURE_DP_TRAIN = {"batch": ["pod", "data", "model"], "act_heads": None,
                  "act_ff": None}
_PURE_DP_TRAIN_MULTI = {"batch": ["data", "model"], "act_heads": None,
                        "act_ff": None}
_SEQ_PARALLEL = {"seq": "model", "act_heads": None, "act_ff": None}

TUNED: dict[tuple, dict] = {
    # mistral-large-123b train: remat off (the reference's hillclimb)
    ("mistral-large-123b", "train_4k", None): {"remat": False},
    # internvl2-1b (d=896): the reference's hillclimb cells
    ("internvl2-1b", "train_4k", "single"): {"sharding_overrides": _PURE_DP_TRAIN},
    ("internvl2-1b", "train_4k", "multi"): {"sharding_overrides": _PURE_DP_TRAIN_MULTI},
    ("internvl2-1b", "prefill_32k", None): {"sharding_overrides": _SEQ_PARALLEL},
    # whisper-tiny (d=384): the same degenerate-TP pathology as internvl
    ("whisper-tiny", "train_4k", "single"): {"sharding_overrides": _PURE_DP_TRAIN},
    ("whisper-tiny", "train_4k", "multi"): {"sharding_overrides": _PURE_DP_TRAIN_MULTI},
    ("whisper-tiny", "prefill_32k", None): {"sharding_overrides": _SEQ_PARALLEL},
}


def tuned_overrides(arch: str, shape: str, mesh: str) -> dict:
    for key in ((arch, shape, mesh), (arch, shape, None), (arch, None, mesh),
                (arch, None, None)):
        if key in TUNED:
            return dict(TUNED[key])
    return {}
