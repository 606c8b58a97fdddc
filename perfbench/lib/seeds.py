"""Seeds derived from the run's ``--seed`` (any whole number, beyond 32
bits too) and a purpose, so that every stream is fixed by the seed alone."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *purpose) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` and
    the ``purpose`` (strings and numbers)."""
    text = "/".join(str(x) for x in (int(seed),) + purpose)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
