"""Logical-axis parameter trees (the port of the JAX package's
``repro/parallel/logical.py``).

A :class:`Logical` leaf is a tensor (a meta tensor during abstract init)
tagged with *logical* axis names ("embed", "heads", "ff", "experts", ...);
:func:`split_logical` separates a tree of them into (values, specs) given
the logical->mesh rules of :mod:`repro_torch.parallel.sharding`.  A tree is
nested dicts.

The port's models are ``nn.Module``s: each parameter records its logical
axes where it is made (``logical_axes``, the reference's axes for the
same leaf without the stacked ``layer`` axis), and :func:`logical_axes`
reads them by parameter name.  :func:`reference_axes` gives the same axes
under the reference's leaf names, with the ``layer`` axis where the
reference stacks the blocks.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .sharding import logical_to_spec


class Logical(NamedTuple):
    value: Any                       # torch.Tensor (meta during abstract init)
    axes: tuple[str | None, ...]     # one logical name (or None) per dim


def param(generator: torch.Generator | None, shape: tuple[int, ...],
          axes: tuple[str | None, ...], dtype=torch.float32,
          init: str = "normal", scale: float | None = None,
          device=None) -> Logical:
    """An initialised, logically-tagged parameter: zeros, ones, or normal
    in float32 times ``scale`` (default ``fan_in ** -0.5``) cast to
    ``dtype``, drawn from ``generator``."""
    assert len(shape) == len(axes), (shape, axes)
    if init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    else:
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        s = scale if scale is not None else fan_in ** -0.5
        v = (torch.randn(shape, generator=generator, dtype=torch.float32,
                         device=device) * s).to(dtype)
    return Logical(v, tuple(axes))


def is_logical(x) -> bool:
    return isinstance(x, Logical)


def _map(fn: Callable, tree):
    if is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_logical(tree, rules: dict[str, Any]):
    """(tree of Logical) -> (tree of values, tree of specs)."""
    values = _map(lambda leaf: leaf.value, tree)
    specs = _map(lambda leaf: logical_to_spec(leaf.axes, rules), tree)
    return values, specs


def spec_of(tree, rules: dict[str, Any]):
    return split_logical(tree, rules)[1]


def values_of(tree):
    """Strip Logical wrappers -> plain tensor tree."""
    return _map(lambda leaf: leaf.value if is_logical(leaf) else leaf, tree)


def abstract_init(init_fn: Callable, *args):
    """Run ``init_fn`` (a Logical-tree builder) with the meta device as
    the default, so nothing is allocated: the Logical tree it returns,
    every value a meta tensor of the real shape and dtype (the reference's
    ``jax.eval_shape``)."""
    with torch.device("meta"):
        tree = init_fn(*args)
    return _map(lambda leaf: Logical(leaf.value.to("meta"), leaf.axes),
                tree)


# ---------------------------------------------------------------------------
# the port's modules
# ---------------------------------------------------------------------------


def logical_axes(model: torch.nn.Module) -> dict[str, tuple]:
    """Each parameter's logical axes by its name in
    ``model.named_parameters()``."""
    out = {}
    for name, p in model.named_parameters():
        axes = getattr(p, "logical_axes", None)
        if axes is None:
            raise ValueError(f"parameter {name} records no logical axes")
        out[name] = tuple(axes)
    return out


def reference_axes(model: torch.nn.Module) -> dict[str, tuple]:
    """The logical axes of the reference's parameter tree for ``model``,
    by the reference's dotted leaf name: ``('layer', ...)`` on a leaf the
    reference stacks over the blocks."""
    from ..convert import _reference_names

    axes = logical_axes(model)
    return {ref: (("layer",) + axes[name]) if index is not None
            else axes[name]
            for name, (ref, index) in _reference_names(model).items()}


def logical_tree(model: torch.nn.Module) -> dict:
    """``model``'s parameters as the reference's Logical tree: nested dicts
    by the reference's leaf names, a stacked leaf holding its blocks'
    parameters on a leading ``layer`` axis (a meta model's stay meta)."""
    from ..convert import _nest, _reference_names

    params = dict(model.named_parameters())
    axes = logical_axes(model)
    groups: dict[str, Any] = {}
    for name, (ref, index) in _reference_names(model).items():
        if index is None:
            groups[ref] = Logical(params[name], axes[name])
        else:
            groups.setdefault(ref, []).append((index, name))
    for ref, layers in groups.items():
        if isinstance(layers, list):
            names = [n for _, n in sorted(layers)]
            value = torch.stack([params[n].detach() for n in names])
            groups[ref] = Logical(value, ("layer",) + axes[names[0]])
    return _nest(groups)
