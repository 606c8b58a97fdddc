"""The port's MoE expert choices, recorded for the torch tests that compare
them: ``test_torch_models.py`` (the port against the JAX package) and
``test_torch_cuda.py`` (the card against the CPU).  It imports neither jax
nor the JAX package."""

from __future__ import annotations

import collections

import numpy as np


def record_expert_choices(monkeypatch) -> dict[str, list]:
    """Patch ``repro_torch.models.moe._top_k_dispatch`` so that every MoE
    dispatch appends (gates, the experts chosen), as numpy arrays on the
    host, to the list of the gates' device type (``"cpu"``, ``"cuda"``)
    in the mapping returned, in call order."""
    from repro_torch.models import moe

    choices = collections.defaultdict(list)
    dispatch = moe._top_k_dispatch

    def recording(gates, k, capacity):
        choices[gates.device.type].append(
            (gates.detach().cpu().numpy().copy(),
             moe._top_k(gates, k)[1].cpu().numpy()))
        return dispatch(gates, k, capacity)

    monkeypatch.setattr(moe, "_top_k_dispatch", recording)
    return choices


def expert_flip(got: list, want: list, tie: float
                ) -> tuple[int, int, int] | None:
    """(dispatch index, tokens routed otherwise, tokens) of the first MoE
    dispatch whose expert choices in ``got`` differ from ``want``'s, or
    None.  Both are lists of (gates, experts) in call order.  Each token
    routed otherwise must be a near-tie: at every choice slot where the two
    picked different experts, ``want``'s gates of the two lie within
    ``tie``."""
    assert len(got) == len(want), (len(got), len(want))
    for i, ((_, gi), (gates, wi)) in enumerate(zip(got, want)):
        assert gi.shape == wi.shape, (i, gi.shape, wi.shape)
        rows = np.argwhere((gi != wi).any(-1))
        for g, s in rows:
            a = np.take(gates[g, s], gi[g, s])
            b = np.take(gates[g, s], wi[g, s])
            assert np.abs(a - b).max() <= tie, (i, g, s, a, b)
        if len(rows):
            return i, len(rows), int(np.prod(gi.shape[:-1]))
    return None
