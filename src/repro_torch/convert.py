"""Carry state across from the JAX package without importing it.

The reference dataclasses (``repro.core.tech.TechModel``,
``repro.core.macro.MacroSpec``) reach the port as their plain field dicts —
``dataclasses.asdict`` of the reference object, with enum members given by
name — so a test can hand both packages the same inputs while this package
imports nothing of ``repro``.  Arrays cross as numpy: a model's parameter
tree (:func:`model_params_from_numpy`) and its decode state
(:func:`decode_state_to_numpy`, :func:`decode_state_from_numpy`); a
bfloat16 array may come as ``ml_dtypes.bfloat16`` (what ``np.asarray`` of a
JAX bfloat16 array gives) and is read bit for bit.

A training state crosses as the reference's ``(params, opt_state)`` tuple
of plain trees (:func:`train_state_to_numpy`,
:func:`train_state_from_numpy`): the blocks' leaves stacked on the layer
axis, the optimizer's ``m`` / ``v`` trees shaped like the parameters and
its ``count`` an int32 scalar.  This is also the checkpoint's layout
(:mod:`repro_torch.ckpt`).  numpy has no bfloat16 of its own, so a
bfloat16 leaf the port hands out is a CPU ``torch.bfloat16`` tensor; every
other leaf is a numpy array.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Mapping

import numpy as np
import torch

from .core.macro import MacroSpec
from .core.tech import TechModel
from .device import resolve_device


def _field_value(value: Any, kind: Any) -> Any:
    if isinstance(kind, type) and issubclass(kind, enum.Enum):
        return value if isinstance(value, kind) else kind[value]
    if isinstance(value, list):
        return tuple(value)
    return value


def _from_fields(cls, d: Mapping[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    return cls(**{k: _field_value(v, hints[k]) for k, v in d.items()})


def tech_from_fields(d: Mapping[str, Any]) -> TechModel:
    """The port's :class:`TechModel` from the reference's field dict."""
    return _from_fields(TechModel, d)


def spec_from_fields(d: Mapping[str, Any]) -> MacroSpec:
    """The port's :class:`MacroSpec` from the reference's field dict."""
    return _from_fields(MacroSpec, d)


def mac_operands_from_numpy(a_q: np.ndarray, w_q: np.ndarray,
                            a_scale: np.ndarray, w_scale: np.ndarray,
                            device=None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """numpy int8 operands and float32 scales as the port's tensors on
    ``device`` (``None``: the CUDA card): ``(a_q, w_q, a_scale, w_scale)``
    with int8 operands and float32 scales, contiguous."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    return (put(a_q, torch.int8), put(w_q, torch.int8),
            put(a_scale, torch.float32), put(w_scale, torch.float32))


def csa_operands_from_numpy(operands: np.ndarray, device=None
                            ) -> torch.Tensor:
    """An (H, N) numpy operand stack as the port's contiguous int32 tensor
    on ``device`` (``None``: the CUDA card).  Values must fit in int32."""
    x = np.ascontiguousarray(operands)
    if x.dtype != np.int32:
        if x.size and (x.min() < -2 ** 31 or x.max() >= 2 ** 31):
            raise ValueError("operand values do not fit in int32")
        x = x.astype(np.int32)
    return torch.as_tensor(x, device=resolve_device(device))


def ssm_operands_from_numpy(a: np.ndarray, b: np.ndarray, h0: np.ndarray,
                            device=None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """numpy ``a``, ``b`` (T, D) and ``h0`` (D,) as the port's contiguous
    float32 tensors on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                                 device=dev) for x in (a, b, h0))


def _tensor_from_numpy(x, dtype: torch.dtype,
                       device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``: an ``ml_dtypes``
    bfloat16 array bit for bit, a tensor as it is, anything else through
    ``torch.as_tensor``; then a cast."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.as_tensor(x)
    return t.to(device=device, dtype=dtype)


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


# the reference's trees whose leaves carry a leading layer axis
STACKED = ("blocks", "enc_blocks", "mamba")


def _dtype_name(x) -> str:
    """``x``'s dtype as numpy names it (``float32``, ``bfloat16``)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return x.dtype.name


def model_params_from_numpy(cfg, tree: Mapping[str, Any], device=None):
    """The port's model for ``cfg`` on ``device`` (``None``: the CUDA card)
    holding the JAX package's plain parameter tree ``tree``
    (``split_logical(api.init_params(key), rules)[0]`` with its leaves as
    numpy arrays).

    The reference stacks each block's parameters on a leading ``layer``
    axis (``stack_init``); they are unstacked into ``blocks.<i>`` /
    ``enc_blocks.<i>`` / ``mamba.<i>`` (zamba2's one ``shared_attn`` block
    is not stacked).  A leaf may also be a tensor (a bfloat16 leaf of
    :func:`train_state_to_numpy` or of a checkpoint).  A leaf that is a linear's weight (``attn.wq``) lands
    in that module's ``w``; any other leaf (an MoE router or expert tensor,
    RWKV6's ``mu_*``, ``w0``, ``u``, ``wA`` / ``wB``, Mamba2's ``conv_w``,
    ``A_log``, ``dt_bias``, ``D``) in the parameter of its name.  Every
    parameter must be given once, with the model's shape and dtype."""
    from .models import model_class

    dev = resolve_device(device)
    model = model_class(cfg)(cfg, device=dev)
    params = dict(model.named_parameters())
    filled: set[str] = set()

    def put(name: str, value: np.ndarray) -> None:
        target = name if name in params else f"{name}.w"
        if target not in params:
            raise ValueError(f"{cfg.name}: no parameter for {name!r}")
        p = params[target]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{target}: shape {tuple(value.shape)}, the "
                             f"model's {tuple(p.shape)}")
        dtype = _dtype_name(value)
        if dtype != str(p.dtype).removeprefix("torch."):
            raise ValueError(f"{target}: dtype {dtype}, the model's "
                             f"{p.dtype}")
        with torch.no_grad():
            p.copy_(_tensor_from_numpy(value, p.dtype, dev))
        filled.add(target)

    for name, value in _flatten(tree):
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        top, _, rest = name.partition(".")
        if top in STACKED:
            for i in range(value.shape[0]):
                put(f"{top}.{i}.{rest}", value[i])
        else:
            put(name, value)
    missing = sorted(set(params) - filled)
    if missing:
        raise ValueError(f"{cfg.name}: parameters not given: {missing}")
    return model


def decode_state_to_numpy(state: Mapping[str, torch.Tensor]
                          ) -> dict[str, np.ndarray]:
    """A decode state as numpy arrays, on the host: bfloat16 caches as
    float32 (exact)."""
    out = {}
    for key, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[key] = t.numpy()
    return out


def decode_state_from_numpy(cfg, tree: Mapping[str, np.ndarray],
                            device=None) -> dict[str, torch.Tensor]:
    """A decode state of ``cfg`` (the reference's plain state tree, or
    :func:`decode_state_to_numpy`'s) as the port's tensors on ``device``
    (``None``: the CUDA card), each in the dtype of the family's layout
    (``init_decode_state``): KV caches, token shifts, conv caches and
    ``enc_out`` in the compute dtype, RWKV6's ``wkv`` and Mamba2's ``ssd``
    states in float32, ``pos`` int32."""
    from .models import get_model

    dev = resolve_device(device)
    layout = get_model(cfg).init_decode_state(1, 1, device="meta")
    unknown = set(tree) - set(layout)
    if unknown:
        raise ValueError(f"{cfg.name}: no decode state {sorted(unknown)}")
    return {key: _tensor_from_numpy(np.asarray(value), layout[key].dtype,
                                    dev)
            for key, value in tree.items()}


# ---------------------------------------------------------------------------
# training state: the reference's (params, opt_state) trees
# ---------------------------------------------------------------------------


def reference_leaf_rank(name: str, ndim: int) -> int:
    """The rank of the reference's leaf that holds the port's parameter
    ``name`` of rank ``ndim``: one more under a stacked tree
    (``blocks.<i>``, ``enc_blocks.<i>``, ``mamba.<i>``), where the
    reference's leaf carries the layer axis.  AdamW decays by this rank."""
    top, _, rest = name.partition(".")
    return ndim + int(top in STACKED and rest.split(".")[0].isdigit())


def _reference_names(model) -> dict[str, tuple[str, int | None]]:
    """Each parameter's (reference leaf name, layer index or None): a
    :class:`~repro_torch.models.layers.DcimLinear`'s ``w`` is the leaf of
    the linear's own name, a stacked block's index leaves the name."""
    from .models.layers import DcimLinear

    linears = {name for name, m in model.named_modules()
               if isinstance(m, DcimLinear)}
    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        ref = owner if leaf == "w" and owner in linears else name
        top, _, rest = ref.partition(".")
        index, _, tail = rest.partition(".")
        if top in STACKED and index.isdigit():
            out[name] = (f"{top}.{tail}", int(index))
        else:
            out[name] = (ref, None)
    return out


def _nest(flat: Mapping[str, Any]) -> dict:
    """A dotted-name mapping as nested dicts."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _host(t: torch.Tensor):
    """A tensor on the host: numpy, or a CPU tensor for bfloat16."""
    t = t.detach().cpu()
    return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _reference_tree(model, values: Mapping[str, torch.Tensor]) -> dict:
    """``values`` (by the model's parameter names) as the reference's
    plain tree on the host, each stacked leaf's layers in order; a DTensor
    value (a mesh's pieces) is gathered whole first, on every rank."""
    from .parallel.zero import full_value

    groups: dict[str, list] = {}
    for name, (ref, index) in _reference_names(model).items():
        t = full_value(values[name]).detach().cpu()
        if index is None:
            groups[ref] = _host(t)
        else:
            groups.setdefault(ref, []).append((index, t))
    for ref, layers in groups.items():
        if isinstance(layers, list):
            stacked = torch.stack([t for _, t in sorted(layers,
                                                        key=lambda x: x[0])])
            groups[ref] = _host(stacked)
    return _nest(groups)


def train_state_to_numpy(cfg, model, opt_state: Mapping[str, Any]
                         ) -> tuple[dict, dict]:
    """The port's model and AdamW state as the reference's ``(params,
    opt_state)`` plain trees on the host (module doc): the parameters in
    their dtypes, ``m`` and ``v`` float32, ``count`` an int32 scalar.  On
    a mesh of ranks each leaf is gathered whole (the checkpoint's global
    arrays), so every rank must call it."""
    params = dict(model.named_parameters())
    check = set(params)
    for key in ("m", "v"):
        if set(opt_state[key]) != check:
            raise ValueError(f"{cfg.name}: opt_state[{key!r}] does not "
                             "hold the model's parameters")
    return (_reference_tree(model, params),
            {"count": np.asarray(opt_state["count"].item(), np.int32),
             "m": _reference_tree(model, opt_state["m"]),
             "v": _reference_tree(model, opt_state["v"])})


def train_state_layout(cfg) -> tuple[dict, dict]:
    """The structure of :func:`train_state_to_numpy`'s trees for ``cfg``,
    each leaf a placeholder 0 (a checkpoint's ``tree_like``); the model is
    built on the meta device, so nothing is allocated."""
    from .models import model_class

    model = model_class(cfg)(cfg, device="meta")
    refs = {ref: 0 for ref, _ in _reference_names(model).values()}
    return _nest(refs), {"count": 0, "m": _nest(refs), "v": _nest(refs)}


def train_state_from_numpy(cfg, tree, device=None, mesh=None):
    """The reference's ``(params, opt_state)`` trees (the JAX package's
    leaves as numpy, :func:`train_state_to_numpy`'s, or a checkpoint's) as
    the port's model and AdamW state on ``device`` (``None``: the CUDA
    card).  With a ``mesh`` (a ``DeviceMesh``) the parameters and moments
    are then placed on it by :func:`repro_torch.ckpt.elastic.reshard_tree`,
    the parameters by the logical rules and the moments like them
    (:func:`repro_torch.optim.adamw.opt_specs_like`), each rank keeping
    its pieces."""
    params, opt = tree
    dev = resolve_device(device)
    model = model_params_from_numpy(cfg, params, device=dev)

    def leaf(t: Mapping[str, Any], ref: str):
        for key in ref.split("."):
            t = t[key]
        return t

    state = {"m": {}, "v": {}}
    for name, (ref, index) in _reference_names(model).items():
        for key in ("m", "v"):
            value = leaf(opt[key], ref)
            value = value if index is None else value[index]
            state[key][name] = _tensor_from_numpy(value, torch.float32, dev)
    state["count"] = torch.tensor(int(opt["count"]), dtype=torch.int32,
                                  device=dev)
    if mesh is not None:
        from .ckpt.elastic import reshard_tree
        from .optim.adamw import opt_specs_like
        from .parallel.logical import logical_axes
        from .parallel.sharding import logical_to_spec, rules_for_mesh
        from .parallel.zero import set_parameters

        rules = rules_for_mesh(mesh, cfg.sharding_overrides)
        specs = {name: logical_to_spec(axes, rules)
                 for name, axes in logical_axes(model).items()}
        set_parameters(model, reshard_tree(
            {n: p.detach() for n, p in model.named_parameters()}, mesh,
            specs))
        moment_specs = opt_specs_like(specs)
        for key in ("m", "v"):
            state[key] = reshard_tree(state[key], mesh, moment_specs[key])
    return model, state
