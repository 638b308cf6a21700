"""Straggler detection for the serving loop.

Port of ``StepWatchdog`` from ``repro/distributed/fault.py`` (host only; no
torch): per-round wall-clock tracking, where a round slower than
``threshold × rolling median`` is flagged as a straggler.  ``serve`` feeds
it every burst's wall time (plus a chaos schedule's synthetic slow
seconds) and reports the flags as ``ServeResult.straggler_rounds``.
"""

from __future__ import annotations

import logging
from typing import List

log = logging.getLogger("repro_torch.fault")


class StepWatchdog:
    def __init__(self, threshold: float = 2.5, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.durations: List[float] = []
        self.straggler_steps: List[int] = []
        self.step = 0

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
