"""QTensor — an int8 payload plus the affine map back to real values.

Port of ``repro/core/qtensor.py`` (the INT8 half; ``BlockQTensor`` is not
ported yet):

    real ≈ (data - zero_point) * scale          (per-tensor or per-channel)

``scale`` is stored in the dequantize direction (real = q * scale), which is
what the matmul epilogue consumes.  ``scale`` and ``zero_point`` are tensors,
or Python floats where the reference has a trace-time constant (a calibrated
activation scale, the zero point of symmetric quantization): a float stays
on the host and reaches a kernel as an argument, with no device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

INT8_MIN = -127  # symmetric: avoid -128 so |q| <= 127
INT8_MAX = 127

Param = Union[torch.Tensor, float]


@dataclasses.dataclass
class QTensor:
    """int8 payload + affine dequantization parameters."""

    data: torch.Tensor          # int8
    scale: Param                # f32, broadcastable to ``data`` along ``axis``
    zero_point: Param           # f32, same broadcast rules as ``scale``
    axis: Optional[int] = None  # per-channel axis (None = per-tensor/keepdims)


def _expand(param: Param, axis: Optional[int], ndim: int) -> Param:
    """Reshape a per-channel vector so it broadcasts along ``axis``."""
    if not isinstance(param, torch.Tensor):
        return float(param)
    param = param.to(torch.float32)
    if axis is None or param.dim() == 0:
        return param
    shape = [1] * ndim
    shape[axis] = -1
    return param.reshape(shape)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def div_exact(t: torch.Tensor, s: float) -> torch.Tensor:
    """IEEE ``t / s`` on every device.  On CUDA torch divides by a Python
    (host) scalar as ``t * (1 / s)``, which can differ in the last bit, so
    the divisor goes in as a one-element tensor on ``t``'s device."""
    return torch.div(t, torch.full((), s, dtype=t.dtype, device=t.device))


def rdiv_exact(num: float, t: torch.Tensor) -> torch.Tensor:
    """IEEE ``num / t``.  torch computes ``num / t`` for a Python scalar
    ``num`` as ``reciprocal(t) * num``, which can differ in the last bit."""
    return torch.div(torch.full((), num, dtype=t.dtype, device=t.device), t)


def quantize_affine(x: torch.Tensor, t_min, t_max,
                    axis: Optional[int] = None) -> QTensor:
    """Affine (asymmetric) quantization of ``x`` clipped to [t_min, t_max].

    Maps t_min -> INT8_MIN and t_max -> INT8_MAX; used where calibrated
    thresholds are not symmetric about zero.
    """
    t_min, t_max = _f32(t_min, x), _f32(t_max, x)
    span = torch.clamp_min(t_max - t_min, 1e-12)
    q_scale = rdiv_exact(INT8_MAX - INT8_MIN, span)
    zp = INT8_MIN - t_min * q_scale            # float zero point in q-space
    xq = torch.round(x.to(torch.float32) * _expand(q_scale, axis, x.dim())
                     + _expand(zp, axis, x.dim()))
    xq = torch.clamp(xq, INT8_MIN, INT8_MAX).to(torch.int8)
    return QTensor(data=xq, scale=rdiv_exact(1.0, q_scale), zero_point=zp,
                   axis=axis)


def quantize_symmetric(x: torch.Tensor, amax,
                       axis: Optional[int] = None) -> QTensor:
    """Symmetric quantization: thresholds (-amax, +amax), zero point 0."""
    amax = torch.clamp_min(_f32(amax, x), 1e-12)
    q_scale = rdiv_exact(INT8_MAX, amax)
    xq = torch.round(x.to(torch.float32) * _expand(q_scale, axis, x.dim()))
    xq = torch.clamp(xq, INT8_MIN, INT8_MAX).to(torch.int8)
    return QTensor(data=xq, scale=div_exact(amax, INT8_MAX),
                   zero_point=torch.zeros_like(amax), axis=axis)


def abs_max(x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    if axis is None:
        return x.abs().max()
    reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
    return x.abs().amax(dim=reduce_dims)
