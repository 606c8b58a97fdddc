"""Weights drawn on the device from the seed, in a few large calls.

A configuration's ``init`` lists ``[pattern, law]`` pairs; the first
pattern (``fnmatch``) that a parameter's name matches gives its law:

* ``{"normal": std, "mean": m}``: ``m + std * N(0, 1)``; ``std`` may be
  ``"fan_in"`` (``shape[-2] ** -0.5``, the contraction size of an
  ``x @ w`` weight) or ``"fan_out"`` (``shape[-1] ** -0.5``);
* ``{"uniform": [lo, hi]}``;
* ``{"const": v}``.

For each dtype, one ``randn`` and one ``rand`` call on a generator on the
device fill flat buffers, and every parameter is a view into them, scaled
in place.  The same seed gives the same bits, so the reference draws the
same weights again after the program is freed.
"""

from __future__ import annotations

import fnmatch
import math

import torch

from .seeds import sub_seed


def law_of(name: str, rules: list) -> dict:
    for pattern, law in rules:
        if fnmatch.fnmatchcase(name, pattern):
            return law
    raise KeyError(f"no init rule matches parameter {name!r}")


def _std(law: dict, shape: tuple) -> float:
    std = law["normal"]
    if std == "fan_in":
        return shape[-2] ** -0.5 if len(shape) > 1 else 1.0
    if std == "fan_out":
        return shape[-1] ** -0.5
    return float(std)


def draw(specs: list, rules: list, seed: int, device) -> dict:
    """``{name: tensor}`` for ``specs`` (``[(name, shape, dtype), ...]``)
    on ``device``, drawn from ``seed`` by ``rules``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    out = {}
    dtypes = sorted({d for _, _, d in specs}, key=str)
    for dtype in dtypes:
        mine = [(n, tuple(s), law_of(n, rules)) for n, s, d in specs
                if d == dtype]
        for kind, fill in (("normal", torch.randn), ("uniform", torch.rand)):
            group = [(n, s, law) for n, s, law in mine if kind in law]
            total = sum(math.prod(s) for _, s, _ in group)
            if not total:
                continue
            flat = fill(total, dtype=dtype, device=device, generator=gen)
            off = 0
            for n, s, law in group:
                view = flat[off:off + math.prod(s)].view(s)
                off += math.prod(s)
                if kind == "normal":
                    view.mul_(_std(law, s))
                    if law.get("mean", 0.0):
                        view.add_(float(law["mean"]))
                else:
                    lo, hi = law["uniform"]
                    view.mul_(hi - lo).add_(lo)
                out[n] = view
        for n, s, law in mine:
            if "const" in law:
                out[n] = torch.full(s, float(law["const"]), dtype=dtype,
                                    device=device)
    missing = [n for n, _, _ in specs if n not in out]
    if missing:
        raise KeyError(f"no law draws {missing[:4]}")
    return out


def specs_of(module: torch.nn.Module) -> list:
    """``[(name, shape, dtype)]`` of a module's parameters (it may live on
    the ``meta`` device)."""
    return [(n, tuple(p.shape), p.dtype)
            for n, p in module.named_parameters()]
