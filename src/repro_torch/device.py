"""Device policy of the port: entry points run on the CUDA card unless the
caller asks for the CPU.

Every public entry point that touches tensors takes ``device=``.  ``None``
means the CUDA card; where no card is visible that is an error that names
``device="cpu"``, never a silent move to the CPU.  Tests and CPU tooling pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on (see the module doc)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device=\"cpu\" to run this "
                "entry point on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
