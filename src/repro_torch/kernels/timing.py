"""The time of one call, as the port's tools take it.

:func:`times_ms` is shared by the tile autotuner (:mod:`.autotune`), the
kernel profiler (:mod:`.profile`) and ``chip_smoke.py``.  On the card it
takes CUDA events around each call, with the L2 cache flushed before it (a
model step finds its weights cold) and the device spun for about a
millisecond after the flush, so that the host has queued the call's
launches before the start event runs and host overhead between the events
is not counted as device time.  On the CPU it reads the host clock.
"""

from __future__ import annotations

import time

import torch

#: Bytes written to flush the card's 50 MB L2 cache before each call.
FLUSH_BYTES = 256 * 1024 * 1024

#: Cycles the device spins after the flush (~1 ms at an H100's clock).
SPIN_CYCLES = 2_000_000

#: Calls made before the timed ones (first-use builds, allocator warm-up).
WARMUP = 3


def times_ms(fn, reps: int, device: torch.device) -> list[float]:
    """The time of each of ``reps`` calls of ``fn()`` on ``device``, in
    ms, after :data:`WARMUP` untimed calls (see the module doc)."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    return [s.elapsed_time(e) for s, e in events]
