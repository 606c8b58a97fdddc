"""Checkpointing: atomic, sharded, async-capable, keep-k (the port of the
JAX package's ``repro/ckpt/manager.py``, in its file format, so that
either package reads the other's checkpoints).

Layout (one directory per step):

    <root>/step_00000100/
        manifest.json            # leaf shapes and dtypes, step meta
        shard_00000.npz          # leaf i as array ``a<i>``, this host's

Writes go to ``.tmp_step_<step>_<host>`` and are published by
``os.rename`` (atomic on POSIX), so a crash mid-write never corrupts the
latest checkpoint: the restart scan only considers directories with a
manifest.  ``async_save`` snapshots the tree to host memory at once and
runs the serialize + rename on a background thread; ``wait()`` fences.

A tree is nested dicts, tuples and lists; its leaves are tensors, numpy
arrays and Python numbers, flattened as ``jax.tree.flatten`` does: dict
keys sorted at every level, sequences in order, ``None`` an empty
subtree.  A training state is saved as the reference's ``(params,
opt_state)`` trees (:func:`repro_torch.convert.train_state_to_numpy`).

A bfloat16 leaf is written as the JAX package writes one: 2-byte void
records (``V2``, numpy having no bfloat16 of its own) with ``bfloat16`` in
the manifest's ``dtypes``.  On restore such a leaf is read back bit for
bit as a CPU ``torch.bfloat16`` tensor, where the JAX package's own
loader hands back the void records (ROADMAP.md, "Reference state"); every
other leaf comes back as a numpy array.  The manifest's ``treedef`` is the
port's description of the tree's structure (JSON of its nodes, ``*`` a
leaf), not the repr of a JAX treedef; readers go by the arrays, shapes and
dtypes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

BFLOAT16 = "bfloat16"


def _flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _describe(tree):
    """The structure of ``tree`` as JSON-able nodes (``*``: a leaf)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {str(key): _describe(tree[key]) for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_describe(sub) for sub in tree]}
    return "*"


class _HostLeaf:
    """A leaf on the host as the file holds it: a numpy array and the name
    of the leaf's dtype."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array, self.dtype = array, dtype


def _host_leaf(leaf) -> _HostLeaf:
    """A leaf copied to host memory: a bfloat16 leaf (a tensor, or an
    ``ml_dtypes`` array) as ``V2`` records."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.view(torch.int16).numpy().view("V2").copy(),
                             BFLOAT16)
        return _HostLeaf(t.numpy().copy(), str(t.dtype).removeprefix("torch."))
    a = np.array(leaf)
    if a.dtype.name == BFLOAT16:
        return _HostLeaf(a.view(np.uint16).view("V2"), BFLOAT16)
    return _HostLeaf(a, str(a.dtype))


def _snapshot(tree):
    """``tree`` with every leaf copied to host memory now."""
    return _unflatten(tree, [_host_leaf(leaf) for leaf in _flatten(tree)])


def _leaf_from_file(a: np.ndarray, dtype: str):
    if dtype == BFLOAT16 and a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def save_checkpoint(root: str | Path, step: int, tree, host_id: int = 0,
                    meta: dict | None = None) -> Path:
    root = Path(root)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}_{host_id}"
    tmp.mkdir(parents=True, exist_ok=True)
    leaves = [_host_leaf(leaf) for leaf in _flatten(tree)]
    np.savez(tmp / f"shard_{host_id:05d}.npz",
             **{f"a{i}": leaf.array for i, leaf in enumerate(leaves)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": json.dumps(_describe(tree)),
        "shapes": [list(leaf.array.shape) for leaf in leaves],
        "dtypes": [leaf.dtype for leaf in leaves],
        "time": time.time(),
        "meta": meta or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def _steps(root: Path) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                  if (p / "manifest.json").exists())


def load_checkpoint(root: str | Path, tree_like, step: int | None = None,
                    host_id: int = 0):
    """Restore into the structure of ``tree_like``; returns (tree, step).
    Only ``tree_like``'s structure is read: its leaves may be
    placeholders (:func:`repro_torch.convert.train_state_layout`)."""
    root = Path(root)
    if step is None:
        steps = _steps(root)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    d = root / f"step_{step:08d}"
    dtypes = json.loads((d / "manifest.json").read_text())["dtypes"]
    n = len(_flatten(tree_like))
    if n != len(dtypes):
        raise ValueError(f"{d} holds {len(dtypes)} leaves, the tree {n}")
    with np.load(d / f"shard_{host_id:05d}.npz") as data:
        leaves = [_leaf_from_file(data[f"a{i}"], dtypes[i])
                  for i in range(n)]
    return _unflatten(tree_like, leaves), step


class CheckpointManager:
    """keep-k GC + async save + restart discovery."""

    def __init__(self, root: str | Path, keep: int = 3, host_id: int = 0):
        self.root = Path(root)
        self.keep = keep
        self.host_id = host_id
        self._thread: threading.Thread | None = None
        self.root.mkdir(parents=True, exist_ok=True)

    # -------------------------------------------------------------- sync api
    def save(self, step: int, tree, meta: dict | None = None) -> Path:
        p = save_checkpoint(self.root, step, tree, self.host_id, meta)
        self._gc()
        return p

    def async_save(self, step: int, tree, meta: dict | None = None):
        # snapshot to host memory NOW: training goes on writing the
        # parameters and moments in place
        host_tree = _snapshot(tree)
        self.wait()
        self._thread = threading.Thread(
            target=lambda: (save_checkpoint(self.root, step, host_tree,
                                            self.host_id, meta), self._gc()),
            daemon=True)
        self._thread.start()

    def wait(self, timeout: float | None = None) -> bool:
        """Fence: returns False if the save straggled past ``timeout``."""
        if self._thread is not None:
            self._thread.join(timeout)
            alive = self._thread.is_alive()
            if not alive:
                self._thread = None
            return not alive
        return True

    def restore(self, tree_like, step: int | None = None):
        return load_checkpoint(self.root, tree_like, step, self.host_id)

    def latest_step(self) -> int | None:
        steps = _steps(self.root)
        return steps[-1] if steps else None

    def _gc(self):
        for s in _steps(self.root)[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)
