"""KL-divergence calibration (paper §4.2).

Workflow (mirrors the paper):

1. Run the FP32/bf16 model over a calibration set (the paper uses 600 of the
   3003 newstest2014 sentences) with activation *taps* enabled; every matmul
   input streams its values into a :class:`StreamingHistogram`.
2. For each site, search the saturation threshold that minimizes the
   KL divergence between the clipped-FP32 distribution and its INT8
   projection (Migacz/TensorRT algorithm).
3. Combine per the requested mode — symmetric / independent / conjugate —
   and classify the histogram; ``sparse`` sites opt out of quantization.

The search runs on host in numpy: calibration is offline and O(bins²/stride),
a few ms per site.  Port of ``repro/core/calibration.py``: the numpy search is
the reference's, unchanged; taps store host (numpy float32) copies of the
recorded torch activations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.histogram import HistogramClass, StreamingHistogram, classify
from repro_torch.core.quantize import QuantMode, Thresholds, thresholds_for_mode

_QUANT_LEVELS = 128          # one-sided INT8 target bins (TensorRT uses 128)
_MIN_CANDIDATE = _QUANT_LEVELS
_SEARCH_STRIDE = 8           # evaluate every 8th candidate threshold


# ---------------------------------------------------------------------------
# KL threshold search
# ---------------------------------------------------------------------------

def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """KL(P||Q) over matching supports; zero bins are handled TensorRT-style."""
    mask = p > 0
    if not mask.any() or q[mask].min() <= 0:
        return np.inf
    p = p[mask] / p.sum()
    q = q[mask] / q[mask].sum()
    return float(np.sum(p * np.log(p / q)))


def kl_threshold_search(
    counts: np.ndarray,
    hist_range: float,
    quant_levels: int = _QUANT_LEVELS,
    stride: int = _SEARCH_STRIDE,
) -> float:
    """Find the clipping threshold minimizing KL(P_clip || Q_int8).

    ``counts`` is a one-sided magnitude histogram over [0, hist_range).
    Returns the threshold magnitude (the bin upper edge minimizing KL).
    """
    counts = np.asarray(counts, dtype=np.float64)
    nbins = len(counts)
    total = counts.sum()
    if total == 0 or hist_range == 0.0:
        return float(hist_range) or 1e-6

    best_kl = np.inf
    best_i = nbins
    for i in range(_MIN_CANDIDATE, nbins + 1, stride):
        # reference distribution: clip everything above bin i into bin i-1
        p = counts[:i].copy()
        outliers = counts[i:].sum()
        p[-1] += outliers
        if p.sum() == 0:
            continue
        # candidate: merge i bins into `quant_levels` groups, then expand
        # back uniformly over the *occupied* bins of each group
        group = i / quant_levels
        idx = (np.arange(i) / group).astype(np.int64)
        np.clip(idx, 0, quant_levels - 1, out=idx)
        q_small = np.bincount(idx, weights=counts[:i], minlength=quant_levels)
        occupied = np.bincount(idx, weights=(counts[:i] > 0).astype(np.float64),
                               minlength=quant_levels)
        expand = np.where(occupied > 0, q_small / np.maximum(occupied, 1), 0.0)
        q = expand[idx] * (counts[:i] > 0)
        kl = _kl_divergence(p, q)
        if kl < best_kl:
            best_kl = kl
            best_i = i
    return best_i / nbins * hist_range


def kl_thresholds(hist: StreamingHistogram, mode: QuantMode) -> Thresholds:
    """Mode-specific threshold extraction (paper §4.2 items 1-3)."""
    mode = QuantMode(mode)
    if mode == QuantMode.NAIVE:
        return Thresholds(hist.observed_min, hist.observed_max)
    amax = max(abs(hist.observed_min), abs(hist.observed_max), 1e-12)
    if mode == QuantMode.SYMMETRIC:
        counts, r = hist.magnitude()
        t = min(kl_threshold_search(counts, r), amax)
        return thresholds_for_mode(mode, hist.observed_min, hist.observed_max,
                                   kl_max=t)
    # independent / conjugate: split about zero, search each half.  The
    # signed histogram spans ±range, so clamp each half's threshold to its
    # own observed extremum (a looser threshold only wastes resolution).
    pos_counts, r = hist.positive_half()
    neg_counts, _ = hist.negative_half()
    t_pos = min(kl_threshold_search(pos_counts, r),
                max(hist.observed_max, 1e-12))
    t_neg = min(kl_threshold_search(neg_counts, r),
                max(-hist.observed_min, 1e-12))
    return thresholds_for_mode(mode, hist.observed_min, hist.observed_max,
                               kl_min=-t_neg, kl_max=t_pos)


# ---------------------------------------------------------------------------
# Activation taps
# ---------------------------------------------------------------------------

class Taps:
    """Collects named intermediate activations during a forward pass.

    Models call ``taps.record(name, x)`` at every quantizable matmul input.
    ``None`` taps (the default everywhere) make ``record`` free.  A recorded
    value is copied to the host as float32 numpy right away, so the device
    tensor is not kept alive.
    """

    def __init__(self) -> None:
        self.values: Dict[str, np.ndarray] = {}

    def record(self, name: str, value: torch.Tensor) -> None:
        self.values[name] = value.detach().to(torch.float32).cpu().numpy()


def record(taps: Optional[Taps], name: str, value: torch.Tensor) -> None:
    if taps is not None:
        taps.record(name, value)


# ---------------------------------------------------------------------------
# Calibrator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiteCalibration:
    """Final calibration record for one activation site."""

    name: str
    thresholds: Thresholds
    classification: HistogramClass
    quantize: bool                      # False for sparse sites (paper §4.2)


class Calibrator:
    """Streams tapped activations into per-site histograms.

    ``forward_fn(batch, taps)`` is any callable running the model with taps;
    the calibrator owns no model structure, so the same class calibrates
    every architecture in the zoo.
    """

    def __init__(self, forward_fn: Optional[Callable] = None):
        self._forward = forward_fn
        self.histograms: Dict[str, StreamingHistogram] = {}

    # direct observation (tests / custom loops)
    def observe_site(self, name: str, value) -> None:
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = StreamingHistogram()
        hist.observe(np.asarray(value))

    def observe_taps(self, taps: Taps) -> None:
        for name, value in taps.values.items():
            self.observe_site(name, np.asarray(value))

    def run(self, batches: Iterable) -> "Calibrator":
        assert self._forward is not None, "construct with forward_fn to use run()"
        for batch in batches:
            taps = Taps()
            self._forward(batch, taps)
            self.observe_taps(taps)
        return self

    def compute(self, mode: QuantMode | str = QuantMode.SYMMETRIC
                ) -> Dict[str, SiteCalibration]:
        """Threshold search + classification for every observed site."""
        mode = QuantMode(mode)
        out: Dict[str, SiteCalibration] = {}
        for name, hist in self.histograms.items():
            cls = classify(hist)
            thr = kl_thresholds(hist, mode)
            out[name] = SiteCalibration(
                name=name,
                thresholds=thr,
                classification=cls,
                quantize=(cls.kind != "sparse" and mode != QuantMode.NONE),
            )
        return out
