"""Deterministic synthetic data pipeline with host sharding + prefetch (a
copy of the JAX package's ``repro/data/pipeline.py``: numpy only, so the
port carries it as it is; batches stay numpy until a train step moves them
to its device).

At 1000+ nodes the data layer must be (a) deterministic under restart — a
step index fully determines the batch, so resuming from a checkpoint replays
no examples and skips none — and (b) host-sharded — each host materializes
only its slice of the global batch.  Both properties hold here:

  * tokens are a counter-based hash (splitmix64) of (seed, step, position) —
    no state, O(1) seek to any step;
  * ``host_sharded_loader`` slices the global batch by (host_id, n_hosts) and
    prefetches on a background thread.

The synthetic stream is Zipf-shaped over the vocab so losses/router balance
behave like text rather than uniform noise.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    frontend_tokens: int = 0
    frontend_dim: int = 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class SyntheticCorpus:
    """Counter-based deterministic corpus: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf CDF over the vocab for text-like marginal statistics.
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._cdf = np.cumsum(p / p.sum())

    def batch(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Rows [lo, hi) of the global batch at ``step``."""
        c = self.cfg
        hi = c.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint64)
        pos = np.arange(c.seq_len + 1, dtype=np.uint64)
        ctr = (np.uint64(c.seed) << np.uint64(40)) \
            + (np.uint64(step) << np.uint64(20))
        h = _splitmix64(ctr + (rows[:, None] << np.uint64(32)) + pos[None, :])
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, c.vocab - 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.frontend_tokens:
            fh = _splitmix64(ctr + np.uint64(0xF00D) +
                             (rows[:, None] << np.uint64(32)) +
                             np.arange(c.frontend_tokens * c.frontend_dim,
                                       dtype=np.uint64)[None, :])
            fe = ((fh >> np.uint64(11)).astype(np.float64) / float(1 << 53))
            fe = (fe.reshape(len(rows), c.frontend_tokens, c.frontend_dim)
                  .astype(np.float32) * 2 - 1)
            out["frontend"] = fe
        return out


def host_sharded_loader(corpus: SyntheticCorpus, host_id: int, n_hosts: int,
                        start_step: int = 0, prefetch: int = 2):
    """Generator of this host's batch slices with background prefetch."""
    c = corpus.cfg
    per_host = c.global_batch // n_hosts
    lo = host_id * per_host
    hi = lo + per_host
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put((step, corpus.batch(step, lo, hi)))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
