"""Fault tolerance for long-running training.

The port of ``repro/runtime/fault_tolerance.py``:

  * Preemption-safe training loop: SIGTERM/SIGINT triggers an immediate
    checkpoint and a clean exit; a restart resumes from the checkpoint's
    step with the deterministic data pipeline.
  * Crash recovery: ``restore_latest_good`` walks back over corrupted
    checkpoints.
  * NaN guard: a non-finite loss skips the update and, after ``patience``
    in a row, rolls back to the last checkpoint.

``state["step"]`` is an int.  The step function returns the new state; a
skipped step keeps the old one.
"""
from __future__ import annotations

import signal
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


class PreemptionHandler:
    """Latches SIGTERM/SIGINT; the train loop polls ``should_stop``."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:      # not the main thread
                pass

    def _handle(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def trigger(self) -> None:      # for tests and manual drills
        self._stop = True


@dataclass
class NanGuard:
    """Skip non-finite updates; escalate to rollback after `patience` hits."""

    patience: int = 3
    consecutive: int = field(default=0, init=False)
    total_skipped: int = field(default=0, init=False)

    def check(self, loss) -> str:
        """Returns 'ok' | 'skip' | 'rollback'."""
        if np.isfinite(float(loss)):
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.total_skipped += 1
        return "rollback" if self.consecutive >= self.patience else "skip"


def fault_tolerant_loop(*, state, step_fn, batch_at: Callable[[int], dict],
                        checkpointer, num_steps: int,
                        checkpoint_every: int = 100, device=None,
                        preemption: Optional[PreemptionHandler] = None,
                        nan_guard: Optional[NanGuard] = None,
                        on_metrics: Optional[Callable] = None):
    """The production inner loop: deterministic data, periodic async
    checkpoints, NaN guard with rollback (onto ``device``), preemption-safe
    exit.

    Returns (state, last_step, exit_reason)."""
    preemption = preemption or PreemptionHandler()
    nan_guard = nan_guard or NanGuard()
    step = int(state["step"])
    while step < num_steps:
        if preemption.should_stop:
            checkpointer.wait()
            checkpointer.save(step, state, blocking=True)
            return state, step, "preempted"
        new_state, metrics = step_fn(state, batch_at(step))
        verdict = nan_guard.check(metrics["loss"])
        if verdict == "ok":
            state = new_state
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % checkpoint_every == 0:
                checkpointer.save(step, state, blocking=False)
        elif verdict == "skip":
            step += 1           # drop this batch, keep the old state
        else:                   # rollback
            checkpointer.wait()
            state, restored = checkpointer.restore_latest_good(
                state, device=device)
            step = int(restored)
            nan_guard.consecutive = 0
    checkpointer.wait()
    checkpointer.save(step, state, blocking=True)
    return state, step, "completed"
