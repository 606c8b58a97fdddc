"""Gather whole, then compute: a model's parameters sharded over a mesh of
ranks (ZeRO-3 over every mesh axis), the port's counterpart of what GSPMD
makes of the reference's sharded program.

A parameter placed on a ``DeviceMesh`` is a DTensor whose placements are
those the logical rules name (:func:`shard_model`); each rank holds its
shard.  Where a layer uses a weight it calls :func:`whole`, which gathers
the shards into the whole weight just before use, so every fake-quant and
matmul runs on the whole weight as on one device.  ``whole`` of a plain
tensor is the tensor: the one-device path is unchanged.

The gather's backward reduces the whole weight's gradient back onto the
shards.  The ranks along the batch axes (the mesh axes the rules give
``batch``, ``('pod', 'data')`` by default) hold different rows, so the
gradient is summed over them and divided by their count, the mean of the
per-rank means; the other ranks hold the same rows, and each keeps its
own piece.  The step then computes what the one-device step computes, up
to the order of the gradient sum.

:func:`data_parallel` sets the batch axes for a train step or a serving
launch; :func:`dp_mean` averages a tensor over them (the global loss, the
MoE load-balance statistics) and :func:`dp_all_rows` gathers the global
batch (MoE token groups that span ranks).  That gather has a backward, a
reduce-scatter sum of the gathered rows' gradient onto the ranks that hold
them, so a train step over such groups computes the one-device gradients:
each rank's loss reads only its own rows of the layer's output, and what
every rank computes alike (the global groups' load-balance loss) comes
back summed once per batch rank, which the batch-rank mean of the
parameter gradients divides out.  Tensor dimensions split evenly over the
mesh axes that shard them; an uneven split raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping

import torch
from torch import nn

from . import collectives as C

# (mesh, batch axes) of the step running in this process, or None.  A
# process global, not a context variable: the autograd engine's device
# threads, where a rematerialised block runs again, must see it too.
_AMBIENT: list = [None]


def batch_axes(mesh, rules: dict) -> tuple[str, ...]:
    """The mesh axes ``rules`` give the ``batch`` dimension."""
    b = rules.get("batch")
    axes = (b,) if isinstance(b, str) else tuple(b or ())
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in names if a in axes)


@contextlib.contextmanager
def data_parallel(mesh, axes: tuple[str, ...]):
    """Within the block, :func:`whole`'s backward averages gradients over
    ``mesh``'s ``axes`` and :func:`dp_mean` averages over them."""
    prev, _AMBIENT[0] = _AMBIENT[0], (mesh, tuple(axes))
    try:
        yield
    finally:
        _AMBIENT[0] = prev


@contextlib.contextmanager
def single_batch_rank():
    """Within the block, :func:`dp_mean` and :func:`dp_size_now` see one
    batch rank: for work on rows that are already the global batch's.
    Weights gathered by :func:`whole` inside it would reduce their
    gradients over the default batch axes, so only work without them
    belongs here."""
    prev, _AMBIENT[0] = _AMBIENT[0], None
    try:
        yield
    finally:
        _AMBIENT[0] = prev


def _dims(mesh, axes) -> list[int]:
    names = tuple(mesh.mesh_dim_names)
    return [names.index(a) for a in axes]


def dp_size(mesh, axes) -> int:
    return math.prod(mesh.size(i) for i in _dims(mesh, axes))


def dp_rank(mesh, axes) -> int:
    """This rank's index along ``axes``, the first outermost."""
    r = 0
    for i in _dims(mesh, axes):
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


class _AllMean(torch.autograd.Function):
    """The mean over the batch ranks; its backward passes the gradient on
    unchanged, since every rank holds the same loss of the mean."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = x.detach().clone()
        for i in _dims(mesh, axes):
            C.all_reduce(y, mesh.get_group(i), "sum")
        return y / dp_size(mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def dp_size_now() -> int:
    """The number of ambient batch ranks (:func:`data_parallel`), 1 outside
    a data-parallel step."""
    amb = _AMBIENT[0]
    return 1 if amb is None else dp_size(*amb)


class _AllRows(torch.autograd.Function):
    """Every batch rank's rows; the backward sums the gathered rows'
    gradient over the batch ranks onto each rank's own rows (a
    reduce-scatter, the all-gather's adjoint)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return gather_rows(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        # gather_rows gathers the innermost axis first: undo it outermost
        # first
        for i in _dims(ctx.mesh, ctx.axes):
            g = C.reduce_scatter(g, ctx.mesh.get_group(i), 0)
        return g, None, None


def dp_all_rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Every ambient batch rank's rows of ``x`` (leading dimension) in
    batch-rank order, the global batch's, and the index of this rank's
    first row in it.  The gradient of the gathered rows comes back to
    the rank that holds them, summed over the batch ranks
    (:class:`_AllRows`)."""
    mesh, axes = _AMBIENT[0]
    return _AllRows.apply(x, mesh, axes), dp_rank(mesh, axes) * x.shape[0]


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ambient batch ranks (:func:`data_parallel`);
    ``x`` itself outside one or on a single batch rank."""
    if dp_size_now() == 1:
        return x
    return _AllMean.apply(x, *_AMBIENT[0])


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: size {n} does not split {parts} ways")
    return n // parts


def _gather(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from this rank's piece: gathered over each mesh
    axis that shards it, the innermost first."""
    x = local
    for i in reversed(range(mesh.ndim)):
        pl = placements[i]
        if pl.is_shard():
            x = C.all_gather(x, mesh.get_group(i), pl.dim)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements, reduce_axes):
        ctx.mesh, ctx.placements = mesh, placements
        ctx.reduce_axes = reduce_axes
        return _gather(local, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.mesh, ctx.placements
        names = tuple(mesh.mesh_dim_names)
        reduce = set(ctx.reduce_axes)
        # the ranks along other axes hold the same rows: keep this piece
        for i, pl in enumerate(placements):
            if names[i] not in reduce and pl.is_shard():
                size = _split(g.shape[pl.dim], mesh.size(i), "gradient")
                g = g.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
        # the batch ranks hold different rows: sum their gradients
        for i, pl in enumerate(placements):
            if names[i] not in reduce:
                continue
            if pl.is_shard():
                g = C.reduce_scatter(g, mesh.get_group(i), pl.dim)
            else:
                g = g.clone(memory_format=torch.contiguous_format)
                g = C.all_reduce(g, mesh.get_group(i), "sum")
        n = dp_size(mesh, ctx.reduce_axes)
        return (g / n if n > 1 else g), None, None, None


def whole(p: torch.Tensor) -> torch.Tensor:
    """The whole of a parameter: a DTensor's shards gathered (module doc),
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    amb = _AMBIENT[0]
    reduce_axes = amb[1] if amb is not None and amb[0] == mesh else \
        tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return _Gather.apply(p.to_local(), mesh, tuple(p.placements),
                         reduce_axes)


# ---------------------------------------------------------------------------
# placing tensors and models
# ---------------------------------------------------------------------------


def local_piece(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of ``full`` under ``placements``, taken without
    communication (every rank holds ``full``)."""
    x = full
    for i, pl in enumerate(placements):             # outermost first
        if pl.is_shard():
            size = _split(x.shape[pl.dim], mesh.size(i),
                          f"dimension {pl.dim} of {tuple(full.shape)}")
            x = x.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return x


def distribute(full: torch.Tensor, mesh, placements):
    """``full`` (held whole by every rank) as a DTensor on ``mesh`` with
    ``placements``: each rank keeps a copy of its own piece."""
    from torch.distributed.tensor import DTensor

    local = local_piece(full, mesh, placements).contiguous().clone()
    return DTensor.from_local(local, mesh, list(placements),
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's piece on this rank (sharing its storage), or ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def like(dt, dtype=None, fill: float = 0.0):
    """A DTensor of ``dt``'s shape and placements filled with ``fill``."""
    from torch.distributed.tensor import DTensor

    piece = dt.to_local()
    filled = torch.full(piece.shape, fill, dtype=dtype or dt.dtype,
                        device=piece.device)
    return DTensor.from_local(filled, dt.device_mesh, list(dt.placements),
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (no autograd); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return _gather(t.to_local(), t.device_mesh, t.placements)


def place_tree(tree, mesh, spec_tree):
    """A tree of tensors, each held whole by every rank, as DTensors on
    ``mesh`` with the placements each leaf's spec names (the one
    spec -> placements -> piece step of every placement: :func:`shard_model`
    and :func:`repro_torch.ckpt.elastic.reshard_tree`)."""
    from .sharding import placements

    if isinstance(tree, Mapping):
        return {k: place_tree(tree[k], mesh, spec_tree[k]) for k in tree}
    return distribute(tree, mesh, placements(spec_tree, mesh))


def set_parameters(model: nn.Module, values: Mapping[str, torch.Tensor]
                   ) -> None:
    """Replace ``model``'s parameters named in ``values`` by parameters
    holding those tensors (DTensors from :func:`place_tree`); the logical
    axes each records carry over."""
    for name, value in values.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        old = mod._parameters[leaf]
        new = nn.Parameter(value, requires_grad=old.requires_grad)
        new.logical_axes = old.logical_axes
        mod._parameters[leaf] = new


def shard_model(model: nn.Module, mesh, rules: dict,
                generator: torch.Generator | None = None,
                device=None) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` by ``rules``.

    With ``generator``, ``model`` is a model built on the meta device:
    each module's parameters are made on ``device``, drawn whole by the
    module's own law in :meth:`ZooModel.init_params`'s order, then cut to
    this rank's pieces, so the shards equal the pieces of the one-device
    draw and the largest transient is one module's parameters.  Without
    one, ``model``'s parameters (held whole) are cut."""
    from .sharding import logical_to_spec

    for mod in model.modules():
        axes = {name: p.logical_axes for name, p in mod._parameters.items()}
        if not axes:
            continue
        if generator is not None:
            mod.to_empty(device=device, recurse=False)
            for name, p in mod._parameters.items():
                p.logical_axes = axes[name]
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)
        held = {name: p.detach() for name, p in mod._parameters.items()}
        set_parameters(mod, place_tree(held, mesh, {
            name: logical_to_spec(ax, rules) for name, ax in axes.items()}))
    return model


def gather_rows(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every batch rank's rows of ``t`` (leading dimension) concatenated
    in batch-rank order, on every rank."""
    for i in reversed(_dims(mesh, axes)):
        t = C.all_gather(t, mesh.get_group(i), 0)
    return t
