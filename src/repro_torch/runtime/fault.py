"""Fault tolerance: NaN guard, teacher deadlines, retry/skip, restart loop
(the port's own copy of ``repro/runtime/fault.py``).

The paper's own fault policy ("if such a nearby teacher is not available,
the queries to the teacher will be retried later or skipped") generalizes
to the straggler policy implemented here:

  * ``DeadlineTeacher`` wraps any teacher callable with a deadline; a miss
    returns availability=False and the ODL step trains on nothing (exact
    identity, see oselm mask semantics) instead of stalling the fleet.
  * ``NaNGuard`` watches train metrics; on non-finite loss it rolls back to
    the last good checkpoint and skips the offending data shard.
  * ``run_with_restarts`` is the supervisor loop: run -> crash -> restore ->
    continue, bounded restarts.  It catches every exception, so a caller
    that must not hide a failure counts its attempts (``make_state`` or
    ``run`` calls) against the crashes it expects.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class DeadlineTeacher:
    """Teacher with a response deadline + bounded retries (paper §2.2)."""

    teacher: Callable
    deadline_s: float = 0.05
    max_retries: int = 1
    # test hook: callable returning simulated latency per call
    latency_fn: Optional[Callable[[], float]] = None
    outages: int = 0

    def __call__(self, idx, x):
        for _ in range(self.max_retries + 1):
            t0 = time.monotonic()
            lat = self.latency_fn() if self.latency_fn else 0.0
            if lat <= self.deadline_s:
                return self.teacher(idx, x), True
            # missed deadline -> retry
            del t0
        self.outages += 1
        return None, False


class NaNGuard:
    """Detects non-finite metrics and triggers rollback."""

    def __init__(self, manager, tolerate: int = 0):
        self.manager = manager
        self.tolerate = tolerate
        self.bad_steps = 0
        self.rollbacks = 0

    def check(self, step: int, metrics: dict, state):
        loss = metrics.get("loss", 0.0)
        if hasattr(loss, "detach"):  # a torch tensor, on any device
            loss = loss.detach().cpu()
        loss = float(np.asarray(loss))
        if np.isfinite(loss):
            self.bad_steps = 0
            return state, step, False
        self.bad_steps += 1
        if self.bad_steps <= self.tolerate:
            return state, step, False
        log.warning("non-finite loss at step %d; rolling back", step)
        self.rollbacks += 1
        self.bad_steps = 0
        restored_step, tree = self.manager.restore()
        return tree, restored_step, True


def run_with_restarts(
    make_state: Callable[[], object],
    run: Callable[[object, int], tuple],
    manager,
    max_restarts: int = 3,
):
    """Supervisor: (re)start `run(state, start_step)` after failures,
    restoring from the latest published checkpoint each time."""
    restarts = 0
    while True:
        try:
            if manager.latest_step() is not None:
                start, state = manager.restore()
            else:
                start, state = 0, make_state()
            return run(state, start)
        except Exception as e:  # noqa: BLE001 — supervisor must catch all
            restarts += 1
            log.warning("run failed (%s); restart %d/%d", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
