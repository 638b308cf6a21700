"""Quantization modes (paper §4) and the threshold-driven quantizer.

Port of the parts of ``repro/core/quantize.py`` the translation path uses:
``QuantMode``, ``Thresholds``, ``quantize_with_thresholds`` and
``thresholds_for_mode`` (which the calibrator calls).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor, quantize_affine, quantize_symmetric


class QuantMode(str, enum.Enum):
    NONE = "none"
    NAIVE = "naive"
    SYMMETRIC = "symmetric"
    INDEPENDENT = "independent"
    CONJUGATE = "conjugate"


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Calibrated clipping thresholds for one tensor site."""

    t_min: float
    t_max: float

    @property
    def symmetric(self) -> bool:
        return abs(self.t_min + self.t_max) <= 1e-9 * max(abs(self.t_max), 1e-30)

    def symmetric_envelope(self) -> "Thresholds":
        t = max(abs(self.t_min), abs(self.t_max))
        return Thresholds(-t, t)


def quantize_with_thresholds(x: torch.Tensor, thr: Thresholds,
                             axis: Optional[int] = None) -> QTensor:
    """Clip ``x`` to the calibrated range and quantize (symmetric thresholds
    take the zero-point-free path, asymmetric ones the affine map)."""
    if thr.symmetric:
        return quantize_symmetric(x, np.float32(thr.t_max), axis=axis)
    return quantize_affine(x, np.float32(thr.t_min), np.float32(thr.t_max),
                           axis=axis)


def thresholds_for_mode(
    mode: QuantMode,
    observed_min: float,
    observed_max: float,
    kl_min: Optional[float] = None,
    kl_max: Optional[float] = None,
) -> Thresholds:
    """Combine calibration outputs into final thresholds per mode."""
    mode = QuantMode(mode)
    if mode == QuantMode.NAIVE:
        return Thresholds(float(observed_min), float(observed_max))
    if mode == QuantMode.SYMMETRIC:
        if kl_max is None:
            raise ValueError("symmetric thresholds need kl_max")
        return Thresholds(-float(kl_max), float(kl_max))
    if mode in (QuantMode.INDEPENDENT, QuantMode.CONJUGATE):
        if kl_min is None or kl_max is None:
            raise ValueError(f"{mode.value} thresholds need kl_min and kl_max")
        thr = Thresholds(float(kl_min), float(kl_max))
        return thr if mode == QuantMode.INDEPENDENT else thr.symmetric_envelope()
    raise ValueError(f"no thresholds for mode {mode}")
