"""Serving chaos harness: deterministic, seeded fault injection.

Port of ``repro/serving/chaos.py`` (host only; no torch).  A
:class:`ChaosSchedule` rides along a ``ServingEngine.serve`` call and
injects faults at serving-round edges, the only points where the host
touches the loop:

* **forced preemptions**: at round ``r``, preempt ``n`` running victims
  chosen by a seeded RNG over the running request ids (reproducible, and
  the same victims as the reference's schedule of the same seed);
* **synthetic slow rounds**: seconds added to the round's measured wall
  time and fed to ``distributed/fault.py:StepWatchdog.observe``, so the
  straggler path runs without real sleeps.

Allocator pressure needs no hook here: a small ``n_pages`` with
``overcommit`` does it.  Under any schedule every request's tokens must
equal an uninterrupted serve's, nothing may deadlock, and the allocator
must end with every page reclaimed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ChaosSchedule:
    """Seeded fault plan, keyed by serving round index."""

    seed: int = 0
    # round → number of running requests to force-preempt at that edge
    preempt_rounds: Dict[int, int] = dataclasses.field(default_factory=dict)
    # round → synthetic extra wall seconds (feeds the step watchdog)
    slow_rounds: Dict[int, float] = dataclasses.field(default_factory=dict)

    def victims_for(self, round_idx: int,
                    running_ids: Sequence[int]) -> List[int]:
        """Request ids to preempt at this round edge (deterministic in
        ``(seed, round_idx, running_ids)``)."""
        n = self.preempt_rounds.get(round_idx, 0)
        if n <= 0 or not running_ids:
            return []
        ids = sorted(running_ids)
        rng = np.random.default_rng(self.seed * 1000003 + round_idx)
        take = min(n, len(ids))
        return sorted(int(ids[i])
                      for i in rng.choice(len(ids), size=take, replace=False))

    def slow_for(self, round_idx: int) -> float:
        return float(self.slow_rounds.get(round_idx, 0.0))

    @property
    def n_preemptions_planned(self) -> int:
        return sum(self.preempt_rounds.values())


def make_chaos(seed: int, *, n_rounds: int = 16,
               preempt_every: int = 3, victims_per_round: int = 1,
               slow_every: Optional[int] = None,
               slow_s: float = 1.0) -> ChaosSchedule:
    """Preempt ``victims_per_round`` victims every ``preempt_every`` rounds
    (the offset varies with the seed, so schedules hit different burst
    edges), and optionally mark every ``slow_every``-th round slow."""
    if preempt_every < 1:
        raise ValueError(f"preempt_every must be >= 1, got {preempt_every}")
    offset = seed % preempt_every
    preempt = {r: victims_per_round
               for r in range(1 + offset, n_rounds, preempt_every)}
    slow = {}
    if slow_every:
        slow = {r: slow_s for r in range(slow_every, n_rounds, slow_every)}
    return ChaosSchedule(seed=seed, preempt_rounds=preempt, slow_rounds=slow)
