"""SynDCIM on PyTorch and CUDA: the port of the JAX package ``repro``.

The package mirrors ``repro``'s layout module for module; the JAX package
stays the reference the port is held against.  Entry points take an explicit
``device=``: ``None`` means the CUDA card (an error where there is none),
and the CPU runs only when the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
