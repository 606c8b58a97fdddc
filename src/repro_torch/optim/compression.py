"""Gradient compression for cross-pod data parallelism (the port of the JAX
package's ``repro/optim/compression.py``).

At 2+ pods the gradient all-reduce crosses the slow inter-pod links; the
standard mitigation is int8 quantization with error feedback (EF-SGD
lineage):

    q = int8(round((g + e) / s)),  s = max|g + e| / 127
    e' = (g + e) - s * q                      # residual kept locally
    all-reduce in int32 over the pod group, dequantize, proceed with AdamW.

Where the reference runs the compressed all-reduce inside ``shard_map``
over the ``'pod'`` mesh axis, :func:`compressed_all_reduce_tree` runs it
over a process group (a ``DeviceMesh``'s ``pod`` dimension,
``mesh.get_group('pod')``).  ``torch.round`` rounds half to even as
``jnp.round`` does, so the codes, and the results, are the reference's bit
for bit.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..parallel import collectives as C


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale float32 scalar, new_error float32)."""
    gf = g.to(torch.float32) + err
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) \
        / _f32(127.0, gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress_int8(q_sum: torch.Tensor, scale_sum: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Inverse of a summed compressed all-reduce: the scales are averaged
    and applied to the int32 sum."""
    return q_sum.to(torch.float32) * (scale_sum / _f32(n, q_sum))


def ef_state_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Error-feedback residual buffers (float32, zero)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_all_reduce_tree(grads: Mapping[str, torch.Tensor],
                               err_state: Mapping[str, torch.Tensor],
                               group=None) -> tuple[dict, dict]:
    """All-reduce ``grads`` over ``group`` in int8 with error feedback.
    Returns (mean_grads, new_err_state).

    Two rounds per tensor, as in the reference: (1) agree on a global
    scale (an all-reduce MAX of one float32 scalar), (2) int8-quantize
    against it, all-reduce SUM the codes in int32, dequantize exactly."""
    n = torch.distributed.get_world_size(group)
    means, errs = {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32) + err_state[name]
        amax = torch.amax(torch.abs(gf)).reshape(1)
        C.all_reduce(amax, group, "max")
        s_global = torch.clamp(amax[0] / _f32(127.0, gf), min=1e-12)
        q = torch.clamp(torch.round(gf / s_global), -127, 127) \
            .to(torch.int8)
        errs[name] = gf - q.to(torch.float32) * s_global
        q_sum = C.all_reduce(q.to(torch.int32), group, "sum")
        means[name] = q_sum.to(torch.float32) * s_global / _f32(n, gf)
    return means, errs


def compressed_allreduce_spec() -> str:
    return ("int8 + error feedback over the 'pod' axis; dense implicit "
            "reduce within pods")
