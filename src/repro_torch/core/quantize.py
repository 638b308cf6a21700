"""Quantization modes (paper §4) and activation/weight quantizers.

Port of ``repro/core/quantize.py``: ``QuantMode``, ``Thresholds``,
``thresholds_for_mode`` (which the calibrator calls), the threshold-driven
``quantize_with_thresholds``, the dynamic, weight and naive quantizers, and
the quantize→dequantize round trips (``fake_quant``) of the Table-1
experiments.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtensor import (
    QTensor,
    abs_max,
    quantize_affine,
    quantize_symmetric,
    quantize_tensor_minmax,
)


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


def quantize_dynamic(x: torch.Tensor, axis: Optional[int] = None) -> QTensor:
    """Dynamic symmetric quantization (per-call abs-max), per tensor or
    per ``axis``."""
    return quantize_symmetric(x, abs_max(x, axis=axis), axis=axis)


def quantize_weight(w: torch.Tensor, channel_axis: int = -1) -> QTensor:
    """Per-output-channel symmetric weight quantization along
    ``channel_axis`` (abs-max per channel): the reference's
    ``core/quantize.py:quantize_weight``, kept for parity with its API and
    not exported from ``repro_torch.core``.  The model path quantizes its
    weights with ``core.ptq.quantize_weight`` (keepdims scales), which is
    the ``quantize_weight`` that ``repro_torch.core`` exports."""
    axis = channel_axis % w.dim()
    return quantize_symmetric(w, abs_max(w, axis=axis), axis=axis)


def quantize_naive(x: torch.Tensor, axis: Optional[int] = None) -> QTensor:
    """Paper §4.1: absolute Min/Max mapping (kept for the Table-1 repro)."""
    return quantize_tensor_minmax(x, axis=axis)


def fake_quant(x: torch.Tensor, thr: Thresholds,
               axis: Optional[int] = None) -> torch.Tensor:
    """Quantize → dequantize round trip in ``x``'s dtype: INT8 accuracy
    loss without the int8 kernels."""
    return quantize_with_thresholds(x, thr, axis=axis).dequantize(x.dtype)


def fake_quant_dynamic(x: torch.Tensor,
                       axis: Optional[int] = None) -> torch.Tensor:
    return quantize_dynamic(x, axis=axis).dequantize(x.dtype)


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
