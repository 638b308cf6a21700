"""Fault tolerance and straggler plumbing (port of
``repro/distributed/fault.py``; host only, no torch).

* **Step watchdog** — per-step wall-clock tracking; a step slower than
  ``threshold × rolling median`` is flagged as a straggler.  The training
  loop brackets each step with ``start``/``stop``; ``serve`` feeds every
  burst's wall time (plus a chaos schedule's synthetic slow seconds) to
  ``observe`` and reports the flags as ``ServeResult.straggler_rounds``.
* **Retry wrapper** — ``run_with_restarts`` re-enters a restartable job
  (one that restores from its own checkpoints) after a transient failure,
  a bounded number of times.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.fault")


class StepWatchdog:
    def __init__(self, threshold: float = 2.5, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.durations: List[float] = []
        self.straggler_steps: List[int] = []
        self._t0: Optional[float] = None
        self.step = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record the step; returns True if it was a straggler."""
        if self._t0 is None:
            # raised, not asserted: the pairing must hold under python -O
            raise RuntimeError("watchdog.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Record a step of ``dt`` seconds against the rolling median;
        returns True if it was a straggler.  Fault injectors feed synthetic
        slow rounds here without faking wall clocks."""
        self.step += 1
        hist = self.durations[-self.window:]
        self.durations.append(dt)
        if len(hist) >= 5:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.threshold * med:
                self.straggler_steps.append(self.step)
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            self.step, dt, med)
                return True
        return False

    def summary(self) -> dict:
        if not self.durations:
            return {"steps": 0}
        d = sorted(self.durations)
        return {
            "steps": len(d),
            "median_s": d[len(d) // 2],
            "p95_s": d[int(len(d) * 0.95)],
            "stragglers": len(self.straggler_steps),
        }


def run_with_restarts(
    fn: Callable[[], None],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    retry_on: tuple = (RuntimeError, OSError),
) -> None:
    """Run ``fn`` (a restartable job that restores from its own
    checkpoints), retrying on transient failures."""
    attempt = 0
    while True:
        try:
            fn()
            return
        except retry_on as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            log.warning("restart %d/%d after %r", attempt, max_restarts, e)
            if on_restart is not None:
                on_restart(attempt, e)
