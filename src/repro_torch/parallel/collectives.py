"""The collectives a mesh of ranks runs, counted (the counterpart of the
collectives GSPMD inserts into the reference's sharded programs).

Every collective of the scale-out path goes through this module:
:func:`all_gather` and :func:`reduce_scatter` along a tensor dimension,
:func:`all_reduce` (sum or max) and :func:`broadcast`.  Each call adds the
bytes this rank hands in to ``TRAFFIC[op]`` and one to ``CALLS[op]``, so a
caller reads what one step moved (:func:`reset_counts`, then the counters).
Within :func:`recording` each counted call also appends ``(op, bytes
handed in, group size, dtype)`` to a call log, from which the dry run
(:mod:`repro_torch.roofline.op_cost`) takes each collective's ring
traffic.

The backend is the process group's, chosen by the launcher's flag; a
collective the backend cannot run raises, and nothing here tries another
route.  On the card, gloo runs all five collectives on CUDA tensors
(``probes/gloo_cuda.py``; gloo itself copies them through host memory),
so none is staged by this module.  DTensor's own collectives are not used:
under gloo on CUDA tensors they crash the process (PERF.md, open
questions); DTensors here are containers of each rank's piece.

:func:`probe` checks which collectives a group runs on a device, for the
dtypes the scale-out path hands them.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch
import torch.distributed as dist

OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce_sum",
       "all_reduce_max", "broadcast")

TRAFFIC: Counter = Counter()      # bytes handed in, per collective
CALLS: Counter = Counter()        # calls, per collective

# the active call log, or None.  A process global, as the batch axes of
# ``parallel.zero``: a backward's collectives run on autograd threads.
_LOG: list = [None]


def reset_counts() -> None:
    TRAFFIC.clear()
    CALLS.clear()


@contextlib.contextmanager
def recording():
    """Within the block, every counted call also appends ``(op, bytes
    handed in, group size, dtype name)`` to the list it yields."""
    prev, log = _LOG[0], []
    _LOG[0] = log
    try:
        yield log
    finally:
        _LOG[0] = prev


def _count(op: str, t: torch.Tensor, n: int) -> None:
    nbytes = t.numel() * t.element_size()
    TRAFFIC[op] += nbytes
    CALLS[op] += 1
    if _LOG[0] is not None:
        _LOG[0].append((op, nbytes, n, str(t.dtype).removeprefix("torch.")))


def _size(group) -> int:
    return dist.get_world_size(group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's pieces ``t`` concatenated along ``dim`` in rank order
    (every piece has ``t``'s shape)."""
    n = _size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _count("all_gather_into_tensor", src, n)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group of ``t``, cut along ``dim`` into as many
    equal pieces as the group has ranks: this rank's piece."""
    n = _size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of size "
                         f"{src.shape[0]} does not split {n} ways")
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _count("reduce_scatter_tensor", src, n)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """``t`` reduced in place over the group (``op``: ``sum`` or ``max``);
    returns ``t``."""
    n = _size(group)
    if n == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _count(f"all_reduce_{op}", t, n)
    dist.all_reduce(t, red, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten in place by global rank ``src``'s; returns ``t``."""
    n = _size(group)
    if n == 1:
        return t
    _count("broadcast", t, n)
    dist.broadcast(t, src, group=group)
    return t


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

PROBE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def probe(device, group=None, ops=OPS, dtypes=PROBE_DTYPES
          ) -> dict[str, dict[str, str]]:
    """Which collectives the group runs on ``device``: ``{op: {dtype:
    "ok" | "wrong" | "<error type>: <message>"}}`` for ``ops`` on
    ``dtypes``, each called directly on small tensors whose result is
    known.  A collective that crashes the process records nothing: run one
    per process to tell them apart."""
    rank, n = dist.get_rank(group), _size(group)
    dev = torch.empty(0, device=device).device
    out: dict[str, dict[str, str]] = {}

    def piece(r, dtype, k=4):
        return (torch.arange(k, device=dev) + 10 * r).to(dtype)

    for op in ops:
        out[op] = {}
        for dtype in dtypes:
            name = str(dtype).removeprefix("torch.")
            try:
                if op == "all_gather_into_tensor":
                    got = torch.empty(4 * n, dtype=dtype, device=dev)
                    dist.all_gather_into_tensor(got, piece(rank, dtype),
                                                group=group)
                    want = torch.cat([piece(r, dtype) for r in range(n)])
                elif op == "reduce_scatter_tensor":
                    got = torch.empty(4, dtype=dtype, device=dev)
                    dist.reduce_scatter_tensor(got, piece(rank, dtype, 4 * n),
                                               group=group)
                    full = sum(piece(r, dtype, 4 * n).to(torch.float64)
                               for r in range(n))
                    want = full[4 * rank:4 * rank + 4].to(dtype)
                elif op in ("all_reduce_sum", "all_reduce_max"):
                    got = piece(rank, dtype)
                    red = (dist.ReduceOp.SUM if op.endswith("sum")
                           else dist.ReduceOp.MAX)
                    dist.all_reduce(got, red, group=group)
                    ps = [piece(r, dtype).to(torch.float64)
                          for r in range(n)]
                    want = (sum(ps) if op.endswith("sum")
                            else torch.stack(ps).amax(0)).to(dtype)
                else:
                    got = piece(rank, dtype)
                    dist.broadcast(got, 0, group=group)
                    want = piece(0, dtype)
                if got.device != dev:
                    out[op][name] = f"moved to {got.device}"
                else:
                    out[op][name] = ("ok" if torch.equal(got.cpu(),
                                                         want.cpu())
                                     else "wrong")
            except Exception as e:      # a probe records what failed
                msg = str(e).strip().splitlines()[0][:120] if str(e) else ""
                out[op][name] = f"{type(e).__name__}: {msg}"
    return out
