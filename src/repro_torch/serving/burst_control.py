"""Adaptive decode-burst length (``burst_len="auto"``).

Port of ``repro/serving/burst_control.py``.  A row (or beam group) that
finishes at step ``s`` of a ``K``-step burst computes ``K - s`` masked
steps before the host can refill it at the burst edge, while a shorter
burst pays more host round trips.  The right ``K`` depends on two costs
measured at run time:

* ``t_sync``: the fixed cost of one burst dispatch and its drain, which
  longer bursts amortize;
* ``t_step``: the cost of one grid step, the unit mid-burst waste is
  counted in.

:class:`AdaptiveBurst` estimates both from per-burst wall times and moves
the step cap between bursts: it shrinks when the waste of the last burst
cost more than one sync, and grows when it cost far less.  The cap takes
power-of-two values in ``[1, max_burst]``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.data.sorting import next_pow2


class AdaptiveBurst:
    """Online controller for the serve loop's burst step cap.

    Read :attr:`k` before each burst and call :meth:`observe` with the
    burst's measurements after its drain.
    """

    #: fraction of a burst's wall time that seeds ``_t_sync``: the first
    #: measured burst cannot separate step cost from sync overhead
    SYNC_SEED_FRAC = 0.1
    #: grow when the last burst's waste cost under 1/GROW_MARGIN of a sync
    GROW_MARGIN = 4.0
    #: weight of the newest burst in the ``_t_sync`` moving average
    EMA = 0.3

    def __init__(self, start: int = 8, max_burst: int = 64):
        if max_burst < 1:
            raise ValueError(f"max_burst must be ≥ 1, got {max_burst}")
        self.max_burst = next_pow2(max_burst)
        self.k = max(1, min(next_pow2(start), self.max_burst))
        self._t_step: Optional[float] = None   # least observed s/step
        self._t_sync: Optional[float] = None   # EMA of fixed per-burst cost
        self._observed = 0
        self.shrinks = 0
        self.grows = 0

    @property
    def t_sync_s(self) -> float:
        return self._t_sync or 0.0

    @property
    def t_step_s(self) -> float:
        return self._t_step or 0.0

    def observe(self, wall_s: float, steps: int, wasted_row_steps: int,
                rows: int) -> int:
        """Feed one burst's measurements; returns the next step cap.

        ``wall_s``: dispatch-to-drain wall time of the burst; ``steps``:
        grid steps the burst took; ``wasted_row_steps``: Σ over occupied
        rows of the steps computed after the row finished; ``rows``: grid
        rows (every row computes every step).
        """
        if steps <= 0 or rows <= 0 or wall_s <= 0.0:
            return self.k
        self._observed += 1
        if self._observed == 1:
            return self.k            # burn-in: the first burst warms up
        per_step = wall_s / steps
        if self._observed == 2:
            # burn-in, part two: this per-step time still carries the whole
            # sync overhead, so seed both estimates conservatively
            self._t_step = per_step
            self._t_sync = self.SYNC_SEED_FRAC * wall_s
            return self.k
        self._t_step = min(self._t_step, per_step)
        overhead = max(wall_s - steps * self._t_step, 0.0)
        self._t_sync = (1.0 - self.EMA) * self._t_sync + self.EMA * overhead
        waste_s = (wasted_row_steps / rows) * self._t_step
        if wasted_row_steps == 0 and self.k < self.max_burst:
            # no row finished mid-burst: a longer burst only saves syncs
            self.k *= 2
            self.grows += 1
        elif waste_s > self.t_sync_s and self.k > 1:
            # the waste cost more than the sync it saved: halve the burst
            self.k //= 2
            self.shrinks += 1
        elif waste_s * self.GROW_MARGIN < self.t_sync_s and \
                self.k < self.max_burst:
            self.k *= 2
            self.grows += 1
        return self.k
