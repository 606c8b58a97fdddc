"""Failure injection + restart-driver: the fault-tolerance drill (a copy
of the JAX package's ``repro/ckpt/failures.py``, which is plain Python).

``run_with_restarts`` is the production control loop in miniature: run the
step function; on (injected or real) failure, tear down, restore the latest
checkpoint, and continue — bounded by ``max_restarts``.  Determinism of the
data pipeline (counter-based batches) makes the restart exactly-once.

Straggler mitigation: the checkpoint fence (CheckpointManager.wait with
timeout) bounds how long a slow host can hold the job; on fence timeout the
driver treats it as a failure and restarts on the surviving capacity
(an elastic re-mesh: :func:`repro_torch.ckpt.elastic.reshard_tree`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given steps (once each)."""

    fail_at: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


def run_with_restarts(step_fn: Callable[[int, dict], dict], state: dict,
                      n_steps: int, manager, save_every: int = 10,
                      injector: FailureInjector | None = None,
                      max_restarts: int = 3) -> dict:
    """Drive ``step_fn`` with checkpoint/restart.

    step_fn(step, state) -> state.  ``state`` must be a checkpointable pytree
    with an integer ``state['step']``.
    """
    restarts = 0
    step = int(state["step"])
    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            state = step_fn(step, state)
            step += 1
            state["step"] = step
            if step % save_every == 0 or step == n_steps:
                manager.save(step, state)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            last = manager.latest_step()
            if last is None:
                step = 0
                state["step"] = 0
                continue
            state, step = manager.restore(state, last)
            step = int(state["step"])
    state["restarts"] = restarts
    return state
