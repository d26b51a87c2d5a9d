"""Fault-tolerance runtime: step journal, straggler monitor, auto-restart
(port of ``repro.runtime``, plain Python, copied so that the port imports
nothing of the reference).

* :class:`StepJournal` — append-only jsonl of (step, wall, metrics); a
  restarted job reads the journal + latest checkpoint and resumes exactly.
* :class:`StragglerMonitor` — EWMA step-time tracker; flags steps slower
  than ``threshold×`` the moving average (logged and counted).
* :func:`run_with_restarts` — supervisor loop: run the step function,
  on exception restore from the last checkpoint and continue, up to
  ``max_restarts`` (the single-process analogue of a job reschedule).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional


class StepJournal:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, step: int, **fields):
        rec = {"step": step, "time": time.time(), **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def last_step(self) -> Optional[int]:
        if not os.path.exists(self.path):
            return None
        last = None
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    last = json.loads(line)["step"]
        return last


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    alpha: float = 0.2  # EWMA weight
    ewma: Optional[float] = None
    flagged: int = 0

    def observe(self, step_time: float) -> bool:
        """Returns True when the step is a straggler."""
        slow = self.ewma is not None and step_time > self.threshold * self.ewma
        if slow:
            self.flagged += 1
        else:
            # only fold non-straggler steps into the moving average
            self.ewma = (step_time if self.ewma is None
                         else (1 - self.alpha) * self.ewma + self.alpha * step_time)
        return slow


def run_with_restarts(step_fn: Callable[[int], dict],
                      start_step: int,
                      num_steps: int,
                      restore_fn: Callable[[], int],
                      max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, BaseException], None]] = None):
    """Supervisor: run ``step_fn(step)`` for ``num_steps``; on exception,
    call ``restore_fn() -> resume_step`` and continue.  Raises after
    ``max_restarts`` consecutive failures (crash loop)."""
    step = start_step
    end = start_step + num_steps
    restarts = 0
    while step < end:
        try:
            step_fn(step)
            step += 1
            restarts = 0
        except BaseException as e:  # noqa: BLE001 — supervisor boundary
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(step, e)
            step = restore_fn()
    return step
