"""DCIM serving roofline: close the compiler -> serving loop.

The counterpart of the JAX package's ``repro/roofline/dcim.py``, with the
H100 figures of :mod:`repro_torch.roofline.hw` in place of the TPU's.  The
multi-spec synthesis engine picks a macro per deployed workload (the JAX
package's ``repro.serve.select.select_macros``); this module answers "how
fast does the deployment actually serve on it?".  Macro wallclock alone
overstates throughput: the macro array only computes as fast as HBM can stream
activations in and results out (weights are resident, that's the point of
CIM — but the act/psum traffic still pays the memory wall).  The serving
bound is the classic two-term roofline

    bound_s = max(t_macro / kernel_fraction, t_hbm)

where ``t_macro`` is the co-design matrix's wallclock for the workload's GEMM
inventory on the selected macro (already clamped to the reporting frequency),
and ``t_hbm`` streams the inventory's activation/output bytes plus one weight
residency load through :data:`repro_torch.roofline.hw.HBM_BW`.

``kernel_fraction`` closes the loop against *measurement*: the analytic
compute term assumes the execution kernels perfectly overlap operand
streaming with arithmetic.  The DMA/compute profiling harness
(:mod:`repro_torch.kernels.profile`) measures how true that is — its
``roofline_fraction`` is the share of fused kernel time the slower pipeline
side accounts for.  Feeding the measured fraction (e.g. via
``fraction_from_profiles``) derates the compute term, turning the ideal
roofline into a measured-pipeline-efficiency roofline.  The default 1.0
keeps every existing caller's numbers bit-identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from . import hw

#: Accumulator output width in bytes streamed back per output element (the
#: OFU emits sign-extended partial sums; 4 B covers every supported mode).
_OUT_BYTES = 4


@dataclass(frozen=True)
class DcimServingEstimate:
    """Roofline-bounded serving estimate for one (workload, macro) pair."""

    workload: str
    macro: str
    tokens: int                # tokens per model step (the GEMM m dim)
    t_macro_s: float           # macro-array compute wallclock per step
    t_hbm_s: float             # HBM streaming time per step
    bound_s: float             # max of the two — the serving step time
    tokens_per_s: float        # roofline-bounded serving throughput
    bottleneck: str            # "macro-compute" | "hbm"
    kernel_fraction: float = 1.0   # measured pipeline efficiency applied

    def summary(self) -> dict:
        out = {
            "workload": self.workload, "macro": self.macro,
            "tokens": self.tokens,
            "t_macro_ms": round(self.t_macro_s * 1e3, 4),
            "t_hbm_ms": round(self.t_hbm_s * 1e3, 4),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "bottleneck": self.bottleneck,
        }
        if self.kernel_fraction != 1.0:
            out["kernel_fraction"] = round(self.kernel_fraction, 4)
        return out


def inventory_bytes(gemms: Sequence, ib: int = 8, wb: int = 8
                    ) -> tuple[float, float]:
    """(activation+output bytes, weight bytes) one model step moves over HBM.

    Activations stream in at the serving precision (``ib`` bits), outputs
    stream back at accumulator width; weights are loaded once per step for
    residency — ``count`` scales both terms, since each GEMM instance (e.g.
    one decoder layer's wq) owns distinct weights (weight-stationary
    mapping — reload churn beyond residency is already priced into the macro
    wallclock by the co-design matrix)."""
    act = sum(g.count * (g.m * g.k * ib / 8 + g.m * g.n * _OUT_BYTES)
              for g in gemms)
    wt = sum(g.count * g.k * g.n * wb / 8 for g in gemms)
    return float(act), float(wt)


def dcim_serving_bound(gemms: Sequence, wallclock_s: float, ib: int = 8,
                       wb: int = 8, workload: str = "", macro: str = "",
                       kernel_fraction: float = 1.0) -> DcimServingEstimate:
    """Two-term serving roofline for one workload on its selected macro.

    ``wallclock_s`` is the co-design wallclock of the workload's GEMM
    inventory on the macro array (:class:`repro_torch.core.dse.CodesignReport`),
    i.e. the compute term; the memory term streams the inventory's bytes
    through the HBM bandwidth of :mod:`repro_torch.roofline.hw`.

    ``kernel_fraction`` in (0, 1] derates the compute term by the measured
    pipeline efficiency of the execution kernels (see
    :func:`repro_torch.kernels.profile.fraction_from_profiles` — or pass any
    measured fraction).  1.0 (the default) is the ideal-overlap roofline."""
    if not gemms:
        raise ValueError("need a non-empty GEMM inventory")
    if not 0.0 < kernel_fraction <= 1.0:
        raise ValueError(f"kernel_fraction must be in (0, 1], "
                         f"got {kernel_fraction}")
    tokens = max(g.m for g in gemms)
    act_bytes, wt_bytes = inventory_bytes(gemms, ib, wb)
    t_hbm = (act_bytes + wt_bytes) / hw.HBM_BW
    t_macro = float(wallclock_s) / kernel_fraction
    bound = max(t_macro, t_hbm)
    tps = tokens / bound if bound > 0 else math.inf
    return DcimServingEstimate(
        workload=workload, macro=macro, tokens=tokens,
        t_macro_s=t_macro, t_hbm_s=t_hbm, bound_s=bound,
        tokens_per_s=tps,
        bottleneck="macro-compute" if t_macro >= t_hbm else "hbm",
        kernel_fraction=kernel_fraction)
