"""Per-rank cost of one eager step, traced op by op: FLOPs, bytes,
collective traffic and live memory (the port's counterpart of the JAX
package's ``repro/roofline/hlo_parse.py``, whose ``analyze_hlo_text``
walks the compiled XLA HLO; the port has no HLO, so it watches the aten
ops its eager step runs).

:class:`OpCost` is a ``TorchDispatchMode``: within it every aten op a step
runs, its backward and its rematerialised blocks included, appends a
record to an op log (its name, its tensor operands' and results' shapes
and dtypes, and the operands it writes), and every collective of
:mod:`repro_torch.parallel.collectives` appends its call (bytes handed in,
group size, dtype).  Records alike are kept once with a count.
:func:`analyze` turns the log into the keys ``analyze_hlo_text`` returns,
so ``roofline/report.py`` reads either:

* dot and convolution FLOPs: 2 x |result| x the contracted size, over
  ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and convolutions (``einsum`` and
  ``matmul`` reach these); reductions 2 x |result|, sorts n log2 n, other
  ops |result| (the reference's rules); views, layout, copies, gathers,
  scatters and factories none.  No trip counts are needed: the eager step
  runs every layer and every recompute as ops of its own.
* bytes: the operands read and results written of every op that launches
  a kernel, views free.  An in-place op writes what it mutates (and reads
  it too, unless it only overwrites it), an indexed write (``index_copy_``,
  ``index_put_``, ``scatter_``, ...) writes what its source holds.  This is
  the eager port's own traffic, each op a kernel of its own; the
  reference counts at XLA's fusion boundaries and takes elementwise chains
  as fused (a TPU projection), so the two differ by design.
* collective bytes per rank, the reference's ring factors on the call log:
  all-reduce 2(g-1)/g of the buffer, all-gather (g-1) x the piece handed
  in (the gathered result x (g-1)/g), reduce-scatter (g-1)/g of the
  buffer handed in, broadcast 1x.  ``coll_in_bytes_per_device`` is what
  the launcher's ``mesh:`` line counts: the bytes handed in.

The reference halves float32 tensors (``bf16_normalize``) to undo XLA:CPU's
upcasts of bfloat16 dots; the trace sees the dtypes the card runs, so it
has nothing to undo.

The memory side (:class:`OpCost`'s ``memory``) keeps the bytes of every
storage alive: the arguments registered before the step, then each new
storage an op makes, until it is freed (a weak reference to the storage).
Its peak above the arguments is the step's temporaries; its keys are the
reference's ``memory_analysis`` ones, per rank.
"""

from __future__ import annotations

import json
import math
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..parallel import collectives as C
from . import hw

DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm"}
CONV_OPS = {"convolution", "_convolution", "conv1d", "conv2d"}
REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
              "argmin", "any", "all", "logsumexp", "norm",
              "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
              "cumsum", "cumprod"}
SORT_OPS = {"sort", "topk", "argsort"}
# no FLOPs: factories, copies, layout, gathers and scatters (the reference's
# FLOPS_FREE: broadcast, iota, copy, convert, concatenate, gather, ...)
FREE_OPS = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like",
            "full", "full_like", "new_zeros", "new_ones", "new_full",
            "fill_", "zero_", "arange", "scalar_tensor", "_to_copy",
            "clone", "copy_", "copy", "cat", "stack", "index_select",
            "gather", "index", "_unsafe_index", "index_put", "index_put_",
            "index_copy", "index_copy_", "scatter", "scatter_",
            "slice_scatter", "select_scatter", "as_strided_scatter",
            "diagonal_scatter", "embedding", "constant_pad_nd", "flip",
            "roll", "repeat", "lift_fresh_copy", "embedding_dense_backward",
            "masked_scatter_", "_index_put_impl_"}
# launch no kernel: allocation alone
NO_KERNEL = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided"}
# in-place ops that only overwrite what they write
WRITE_ONLY = {"copy_", "fill_", "zero_", "uniform_", "normal_", "random_",
              "bernoulli_", "exponential_"}
# in-place ops that write their last tensor operand's worth of elements
INDEXED_WRITES = {"index_copy_", "index_put_", "_index_put_impl_",
                  "scatter_", "scatter_add_", "scatter_reduce_",
                  "index_add_", "index_fill_", "masked_scatter_"}
# ring traffic per rank, as a multiple of the bytes handed in
_RING = {"all-gather": lambda g: g - 1,
         "reduce-scatter": lambda g: (g - 1) / g,
         "all-reduce": lambda g: 2 * (g - 1) / g,
         "broadcast": lambda g: 1.0}
# device bytes a collective reads and writes, as a multiple of its input
_HBM = {"all-gather": lambda g: 1 + g, "reduce-scatter": lambda g: 1 + 1 / g,
        "all-reduce": lambda g: 2.0, "broadcast": lambda g: 2.0}
COLL_NAMES = {"all_gather_into_tensor": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
              "broadcast": "broadcast"}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _local(t):
    """A DTensor's piece on this rank (the op this rank runs), or ``t``."""
    return getattr(t, "_local_tensor", t)


_ITEMSIZE: dict[str, int] = {}


def _nbytes(spec) -> int:
    shape, dtype = spec
    size = _ITEMSIZE.get(dtype)
    if size is None:
        size = _ITEMSIZE[dtype] = getattr(torch, dtype).itemsize
    return math.prod(shape) * size


def _numel(spec) -> int:
    return math.prod(spec[0])


# ---------------------------------------------------------------------------
# the cost of an op log
# ---------------------------------------------------------------------------


def op_flops(rec: dict) -> tuple[str | None, float]:
    """(the ``flops_by_op`` key, FLOPs) of one op record."""
    name, ins, outs = rec["op"], rec["in"], rec["out"]
    if name in DOT_OPS:
        lhs = ins[1] if name in ("addmm", "baddbmm", "addbmm") else ins[0]
        return "dot", 2.0 * sum(map(_numel, outs)) * lhs[0][-1]
    if name in CONV_OPS:
        w = ins[1][0]
        return "convolution", 2.0 * sum(map(_numel, outs)) * (
            math.prod(w) // max(w[0], 1))
    if name in FREE_OPS:
        return None, 0.0
    written = [ins[i] for i in rec.get("w", [])] or outs
    n = sum(map(_numel, written))
    if name in REDUCE_OPS:
        return "reduce", 2.0 * n
    if name in SORT_OPS:
        return "sort", n * max(1.0, math.log2(max(2, n)))
    return "elementwise", float(n)


def op_bytes(rec: dict) -> float:
    """Device bytes one op record reads and writes (module doc)."""
    name, ins, outs, w = rec["op"], rec["in"], rec["out"], rec.get("w", [])
    if name in NO_KERNEL:
        return 0.0
    if not w:
        return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
    read = [s for i, s in enumerate(ins) if i not in w]
    if name in INDEXED_WRITES:
        return float(sum(map(_nbytes, read)) + _nbytes(ins[-1]))
    mult = 1 if name in WRITE_ONLY else 2
    return float(sum(map(_nbytes, read))
                 + mult * sum(_nbytes(ins[i]) for i in w))


def analyze(records) -> dict:
    """The keys ``repro.roofline.hlo_parse.analyze_hlo_text`` returns, per
    rank, from an op log (:meth:`OpCost.records`)."""
    flops = nbytes = coll = coll_in = 0.0
    by_flops: Counter = Counter()
    by_bytes: Counter = Counter()
    counts: dict = {}
    n_ops = 0
    for rec in records:
        k = rec.get("n", 1)
        n_ops += k
        if "coll" in rec:
            op, b_in, g = rec["op"], rec["coll"][0], rec["coll"][1]
            ring = b_in * _RING[op](g) * k if g > 1 else 0.0
            hbm = b_in * _HBM[op](g) * k
            coll += ring
            coll_in += b_in * k
            nbytes += hbm
            by_bytes[op] += hbm
            c = counts.setdefault(op, {"count": 0.0, "bytes": 0.0,
                                       "in_bytes": 0.0})
            c["count"] += k
            c["bytes"] += ring
            c["in_bytes"] += b_in * k
            continue
        key, fl = op_flops(rec)
        if fl:
            flops += fl * k
            by_flops[key] += fl * k
        by = op_bytes(rec)
        if by:
            nbytes += by * k
            by_bytes[rec["op"]] += by * k
    return {
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "coll_bytes_per_device": coll,
        "coll_in_bytes_per_device": coll_in,
        "coll_counts": counts,
        "bytes_by_op": dict(sorted(by_bytes.items(),
                                   key=lambda kv: -kv[1])[:8]),
        "flops_by_op": dict(sorted(by_flops.items(),
                                   key=lambda kv: -kv[1])[:8]),
        "n_ops": n_ops,
    }


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class _Live:
    """Bytes of the storages alive, keyed weakly by storage."""

    def __init__(self):
        self.bytes = 0
        self.peak = 0
        self._held: dict[int, weakref.finalize] = {}

    def add(self, storage) -> bool:
        """Count ``storage`` if it is new; whether it was."""
        key = id(storage)
        if key in self._held:
            return False
        n = storage.nbytes()
        fin = weakref.finalize(storage, self._free, key, n)
        fin.atexit = False
        self._held[key] = fin
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        return True

    def has(self, storage) -> bool:
        return id(storage) in self._held

    def _free(self, key: int, n: int) -> None:
        if self._held.pop(key, None) is not None:
            self.bytes -= n

    def close(self) -> None:
        for fin in list(self._held.values()):
            fin.detach()
        self._held.clear()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _written(func, args, kwargs) -> list:
    """The tensor arguments ``func``'s schema marks as written."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += _tensors(v)
    return out


class OpCost(TorchDispatchMode):
    """Trace the aten ops run within it (module doc).

    ``args``: tensors alive before the step that it reads (this rank's
    parameter pieces, optimizer moments, batch rows, decode state); their
    storages are the arguments of :meth:`memory`.  After the block,
    :meth:`records` is the op log, :meth:`cost` its :func:`analyze`, and
    :meth:`memory` the live-bytes accounting."""

    def __init__(self, args=()):
        super().__init__()
        self._ops: Counter = Counter()
        self._live = _Live()
        self._args = []          # the argument storages, kept alive
        for t in _tensors(args):
            st = _local(t).untyped_storage()
            if self._live.add(st):
                self._args.append(st)
        self.argument_bytes = self._live.bytes
        self._live.peak = self._live.bytes
        self._calls = None
        self._log_cm = None

    def __enter__(self):
        self._log_cm = C.recording()
        self._calls = self._log_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._log_cm.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional", "_dtensor"):
            return out          # collectives: from the call log
        name = func.overloadpacket.__name__
        ins = [_local(t) for t in _tensors((args, kwargs))]
        outs = [_local(t) for t in _tensors(out)]
        in_st = {id(t.untyped_storage()) for t in ins}
        new = [t for t in outs if id(t.untyped_storage()) not in in_st]
        w = []
        if func._schema.is_mutable:     # in place, or into an out= tensor
            written = {id(_local(v)) for v in _written(func, args, kwargs)}
            w = [i for i, t in enumerate(ins) if id(t) in written]
        elif outs and not new:
            return out          # a view: no kernel, nothing new
        for t in new:
            self._live.add(t.untyped_storage())
        if not ins and not new and not w:
            return out
        key = (name,
               tuple((tuple(t.shape), _dtype_name(t)) for t in ins),
               tuple((tuple(t.shape), _dtype_name(t)) for t in new),
               tuple(w))
        self._ops[key] += 1
        return out

    # -- results -------------------------------------------------------------

    def records(self) -> list[dict]:
        """The op log: one dict per distinct op (``n``: how many ran) and
        one per distinct collective call."""
        recs = []
        for (name, ins, outs, w), n in self._ops.items():
            rec = {"op": name, "in": [[list(s), d] for s, d in ins],
                   "out": [[list(s), d] for s, d in outs], "n": n}
            if w:
                rec["w"] = list(w)
            recs.append(rec)
        calls = Counter((COLL_NAMES[op], b, g, dt)
                        for op, b, g, dt in self._calls or ())
        for (op, b, g, dt), n in calls.items():
            recs.append({"op": op, "coll": [b, g, dt], "n": n})
        return recs

    def cost(self) -> dict:
        return analyze(self.records())

    def memory(self, outputs=()) -> dict:
        """The reference's ``memory_analysis`` keys for this rank.
        ``argument_size_in_bytes``: the storages registered as arguments;
        ``temp_size_in_bytes``: the peak of live bytes above them;
        ``output_size_in_bytes``: the storages the step made that
        ``outputs`` still hold (inside the peak, so ``total_bytes``, the
        peak itself, is arguments + temporaries); ``fits``: the peak
        within one card's memory (``hw.HBM_PER_CHIP``)."""
        held = {id(st) for st in self._args}
        made = 0
        for t in _tensors(outputs):
            st = _local(t).untyped_storage()
            if id(st) not in held and self._live.has(st):
                held.add(id(st))
                made += st.nbytes()
        arg, peak = self.argument_bytes, self._live.peak
        mem = {"argument_size_in_bytes": arg,
               "output_size_in_bytes": made,
               "temp_size_in_bytes": peak - arg,
               "total_bytes": peak}
        mem["args_bytes_per_device"] = mem["argument_size_in_bytes"]
        mem["temp_bytes_per_device"] = mem["temp_size_in_bytes"]
        mem["total_bytes_per_device"] = mem["total_bytes"]
        mem["fits"] = peak <= hw.HBM_PER_CHIP
        return mem

    def close(self) -> None:
        self._live.close()


def write_ops(path, records) -> None:
    """The op log as gzipped JSON lines."""
    import gzip

    with gzip.open(path, "wt") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def read_ops(path) -> list[dict]:
    import gzip

    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]
