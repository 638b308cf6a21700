"""Streaming activation histograms + distribution classification (paper §4.2).

Calibration is an offline, host-side pass, so this module is numpy — the
observed tensors are pulled off-device once per calibration batch.  The
port keeps its own copy of ``repro/core/histogram.py``, unchanged.

Two pieces:

* ``StreamingHistogram`` — fixed bin *count* (2×2048 signed bins), dynamic
  range.  When a new batch exceeds the current range the range doubles and
  bin counts fold pairwise, so a single pass over the calibration set
  suffices (no separate min/max pre-pass).
* ``classify`` — the paper's Figure-2 taxonomy: **sparse** (mass is almost
  entirely at zero with isolated spikes; quantizing these destroys accuracy
  → keep FP32), **narrow** (mass concentrated in a small slice of the
  observed range; clipping helps a lot), **gaussian** (bell-ish; clipping
  helps a little).  12/97 MatMul inputs were sparse in the paper's model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

HALF_BINS = 2048            # bins per sign → 4096 signed bins, TensorRT-style
_EXPAND = 2.0               # range growth factor (exact pairwise bin folding)


class StreamingHistogram:
    """Signed histogram over [-range, +range] with power-of-two expansion."""

    def __init__(self, half_bins: int = HALF_BINS):
        self.half_bins = int(half_bins)
        self.counts = np.zeros(2 * self.half_bins, dtype=np.int64)
        self.range: float = 0.0          # current |x| range covered
        self.total: int = 0
        self.observed_min: float = np.inf
        self.observed_max: float = -np.inf
        self.zero_count: int = 0         # exact zeros (sparse detection)

    # -- streaming ----------------------------------------------------------
    def observe(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float32).ravel()
        x = x[np.isfinite(x)]
        if x.size == 0:
            return
        self.observed_min = min(self.observed_min, float(x.min()))
        self.observed_max = max(self.observed_max, float(x.max()))
        self.zero_count += int(np.count_nonzero(x == 0.0))
        self.total += int(x.size)

        amax = float(np.abs(x).max())
        if amax > self.range:
            self._expand_to(amax)
        if self.range == 0.0:            # all zeros so far
            return
        # bin index: [-range, range) -> [0, 2*half_bins)
        idx = np.floor((x / self.range + 1.0) * self.half_bins).astype(np.int64)
        np.clip(idx, 0, 2 * self.half_bins - 1, out=idx)
        np.add.at(self.counts, idx, 1)

    def _expand_to(self, amax: float) -> None:
        if self.range == 0.0:
            self.range = amax
            return
        while self.range < amax:
            # fold pairs of bins toward the centre: new bin j covers old
            # bins [2j - half, 2j - half + 1] shifted about the zero bin.
            old = self.counts
            n = self.half_bins
            new = np.zeros_like(old)
            # negative side: old bins [0, 2n) span [-r, r); after doubling,
            # old bin i maps to new bin n + (i - n)//2 (floor toward -inf).
            src = np.arange(2 * n)
            dst = n + np.floor_divide(src - n, 2)
            np.add.at(new, dst, old)
            self.counts = new
            self.range *= _EXPAND

    # -- views ----------------------------------------------------------------
    def edges(self) -> np.ndarray:
        return np.linspace(-self.range, self.range, 2 * self.half_bins + 1)

    def positive_half(self) -> Tuple[np.ndarray, float]:
        """Counts over [0, range) with bin width range/half_bins."""
        return self.counts[self.half_bins:].astype(np.float64), self.range

    def negative_half(self) -> Tuple[np.ndarray, float]:
        """Counts over (0, range] of |negative side| (reversed)."""
        return self.counts[:self.half_bins][::-1].astype(np.float64), self.range

    def magnitude(self) -> Tuple[np.ndarray, float]:
        """|x| histogram: fold the two halves together."""
        pos, r = self.positive_half()
        neg, _ = self.negative_half()
        return pos + neg, r

    # -- statistics -----------------------------------------------------------
    def quantile_abs(self, q: float) -> float:
        """Approximate |x| quantile from the magnitude histogram."""
        counts, r = self.magnitude()
        csum = np.cumsum(counts)
        if csum[-1] == 0:
            return 0.0
        k = int(np.searchsorted(csum, q * csum[-1]))
        k = min(k, len(counts) - 1)
        return (k + 1) / len(counts) * r

    def occupancy(self) -> float:
        nz = int(np.count_nonzero(self.counts))
        return nz / self.counts.size

    def zero_fraction(self) -> float:
        return self.zero_count / max(self.total, 1)


@dataclasses.dataclass(frozen=True)
class HistogramClass:
    kind: str                 # "sparse" | "narrow" | "gaussian"
    zero_fraction: float
    occupancy: float
    p999_over_amax: float


# Classification thresholds — validated by tests/test_calibration.py against
# synthetically generated sparse / narrow / gaussian tensors.
SPARSE_ZERO_FRACTION = 0.90
SPARSE_OCCUPANCY = 0.05
NARROW_P999_RATIO = 0.30


def classify(hist: StreamingHistogram) -> HistogramClass:
    """Paper Fig. 2 taxonomy.  ``sparse`` sites must not be quantized."""
    zf = hist.zero_fraction()
    occ = hist.occupancy()
    amax = max(abs(hist.observed_min), abs(hist.observed_max), 1e-30)
    p999 = hist.quantile_abs(0.999)
    ratio = p999 / amax

    if zf >= SPARSE_ZERO_FRACTION and occ <= SPARSE_OCCUPANCY:
        kind = "sparse"
    elif ratio <= NARROW_P999_RATIO:
        # 99.9% of mass sits in <30% of the observed range: a tight core
        # with long-tail outliers — the paper's "narrow" histograms.
        kind = "narrow"
    else:
        kind = "gaussian"
    return HistogramClass(kind=kind, zero_fraction=zf, occupancy=occ,
                          p999_over_amax=ratio)
