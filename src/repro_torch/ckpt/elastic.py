"""Elastic re-meshing: move a checkpoint onto a different mesh (the port of
the JAX package's ``repro/ckpt/elastic.py``).

When nodes fail (or capacity grows), the job restarts with a different
rank count; parameters saved under one sharding must load under another.
Checkpoints store *global* arrays (the whole tree, gathered before the
save), and placements are recomputed from the logical rules for whatever
mesh exists at restore time, so resharding is a pure placement operation:
every rank holds the whole restored array and keeps its own piece, with no
communication (:func:`repro_torch.parallel.zero.distribute`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..parallel.zero import place_tree


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _on(tree, device):
    if isinstance(tree, Mapping):
        return {k: _on(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def reshard_tree(tree, mesh, spec_tree):
    """Place global (host or device) arrays onto ``mesh`` (a
    ``DeviceMesh``) with per-leaf specs: a tree of DTensors on the mesh's
    device type, each rank holding its piece
    (:func:`repro_torch.parallel.zero.place_tree`)."""
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return place_tree(_on(tree, dev), mesh, spec_tree)
