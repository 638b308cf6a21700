"""QTensor — an int8 payload plus the affine map back to real values; and
BlockQTensor — block-wise INT4 weights.

Port of ``repro/core/qtensor.py``:

    real ≈ (data - zero_point) * scale          (per-tensor or per-channel)
    real[k, n] = q[k, n] * scale[k // G, n] + vmin[k // G, n]    (INT4)

``scale`` is stored in the dequantize direction (real = q * scale), which is
what the matmul epilogue consumes.  ``scale`` and ``zero_point`` are tensors,
or Python floats where the reference has a trace-time constant (a calibrated
activation scale, the zero point of symmetric quantization): a float stays
on the host and reaches a kernel as an argument, with no device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
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

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """``(data - zero_point) * scale`` in float32, cast to ``dtype``."""
        scale = _expand(self.scale, self.axis, self.data.dim())
        zp = _expand(self.zero_point, self.axis, self.data.dim())
        return ((self.data.to(torch.float32) - zp) * scale).to(dtype)

    def nbytes(self) -> int:
        """Payload plus parameters; a float parameter counts as one f32."""
        return sum(p.numel() * p.element_size()
                   if isinstance(p, torch.Tensor) else 4
                   for p in (self.data, self.scale, self.zero_point))


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


# float32(1/127): the reference's jitted programs scale an abs-max by it
# (XLA rewrites ``amax / 127`` into ``amax * float32(1/127)``)
INV_127 = float(np.float32(1.0) / np.float32(127.0))


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


def quantize_tensor_minmax(x: torch.Tensor,
                           axis: Optional[int] = None) -> QTensor:
    """Paper §4.1 "naive" quantization: absolute Min/Max of the tensor."""
    if axis is None:
        t_min, t_max = x.min(), x.max()
    else:
        reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
        t_min, t_max = x.amin(dim=reduce_dims), x.amax(dim=reduce_dims)
    return quantize_affine(x, t_min, t_max, axis=axis)


def abs_max(x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    if axis is None:
        return x.abs().max()
    reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
    return x.abs().amax(dim=reduce_dims)


# ---------------------------------------------------------------------------
# BlockQTensor — block-wise (group) INT4 weights
# ---------------------------------------------------------------------------
#
# The reduction axis (second-to-last, the ``d_in`` of every linear) is split
# into groups of ``group_size`` rows, each with an f16/f32 (scale, vmin) pair
# per output column; codes are unsigned nibbles in [0, 15], packed two per
# int8 along the reduction axis (logical row 2r is the low nibble of packed
# row r, 2r+1 the high one).  ``group_size`` is even, so packing never
# crosses a group.  A K that is not a multiple of the group is padded by
# repeating the last row (edge padding keeps the tail group's min/max, and so
# its scale); ``k_dim`` is the logical K.

INT4_LEVELS = 15  # unsigned nibble codes 0..15


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Pack (..., K, N) int codes in [0, 15] → (..., K//2, N) int8 (K even)."""
    if q.shape[-2] % 2:
        raise ValueError(f"packing needs an even row count, got "
                         f"{tuple(q.shape)}")
    qu = q.to(torch.uint8)
    lo = qu[..., 0::2, :]
    hi = qu[..., 1::2, :]
    return (lo | (hi << 4)).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Unpack (..., K2, N) int8 → (..., 2*K2, N) int32 codes in [0, 15].

    The shifts run on uint8: a right shift of int8 would sign-extend the
    high nibble."""
    pu = packed.view(torch.uint8)
    lo = (pu & 0xF).to(torch.int32)
    hi = (pu >> 4).to(torch.int32)
    stacked = torch.stack([lo, hi], dim=-2)          # (..., K2, 2, N)
    shape = tuple(packed.shape[:-2]) + (2 * packed.shape[-2],
                                        packed.shape[-1])
    return stacked.reshape(shape)                    # row 2r = lo, 2r+1 = hi


@dataclasses.dataclass
class BlockQTensor:
    """Group-wise INT4 payload (two nibbles per int8) + per-block scale/min."""

    data: torch.Tensor    # int8, (..., K_store//2, N): packed nibbles along K
    scale: torch.Tensor   # f16/f32, (..., n_groups, N): dequant scale per block
    vmin: torch.Tensor    # f16/f32, (..., n_groups, N): block minimum
    group_size: int       # rows per block along the reduction axis
    k_dim: int            # logical (unpadded) reduction dim

    @property
    def shape(self):
        """Logical (dequantized) shape."""
        return tuple(self.data.shape[:-2]) + (self.k_dim, self.data.shape[-1])

    @property
    def n_groups(self) -> int:
        return self.scale.shape[-2]

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Unpack the nibbles, apply the block scale/min, cut the padding."""
        q = unpack_nibbles(self.data)                    # (..., K_store, N)
        lead = tuple(self.data.shape[:-2])
        n_g, G, N = self.n_groups, self.group_size, self.data.shape[-1]
        qb = q.reshape(lead + (n_g, G, N)).to(torch.float32)
        s = self.scale.to(torch.float32)[..., :, None, :]
        m = self.vmin.to(torch.float32)[..., :, None, :]
        w = (qb * s + m).reshape(lead + (n_g * G, N))
        return w[..., :self.k_dim, :].to(dtype)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.scale, self.vmin))

    def __repr__(self) -> str:
        return (f"BlockQTensor(shape={self.shape}, "
                f"group_size={self.group_size}, n_groups={self.n_groups}, "
                f"scale_dtype={self.scale.dtype})")


def _pad_edge(w: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the reduction axis (-2) by repeating its last row ``pad`` times."""
    tail = w[..., -1:, :].expand(*w.shape[:-2], pad, w.shape[-1])
    return torch.cat([w, tail], dim=-2)


def quantize_block(w: torch.Tensor, group_size: int = 128,
                   scale_dtype: torch.dtype = torch.float16,
                   refine_iters: int = 3) -> BlockQTensor:
    """Block-quantize ``w`` (..., K, N) to INT4 along the reduction axis.

    Per group of ``group_size`` rows and per output column the affine map
    starts from the group's [min, max] and is refined by ``refine_iters``
    rounds of alternating least squares: given the codes, the MSE-optimal
    (scale, min) is the closed-form regression of the weights on the codes;
    re-round, repeat.  The codes are finally rounded against the *stored*
    (f16) parameters, so the round trip sees what the kernel sees.

    The same op sequence as the reference; every division is an IEEE one
    (``div_exact``/``rdiv_exact`` and tensor-by-tensor ``/``), and
    ``torch.round`` rounds half to even like ``jnp.round``.  The four f32
    sums of each ALS round are reductions over the group axis, whose order
    torch and XLA each choose; ``tests/test_torch_int4.py`` measures how
    often that moves a code.
    """
    if group_size < 2 or group_size % 2:
        raise ValueError(f"group_size must be even and >= 2, got {group_size}")
    lead = tuple(w.shape[:-2])
    K, N = w.shape[-2], w.shape[-1]
    n_g = -(-K // group_size)
    pad = n_g * group_size - K
    wf = w.to(torch.float32)
    if pad:
        wf = _pad_edge(wf, pad)
    wb = wf.reshape(lead + (n_g, group_size, N))
    gmin = wb.amin(dim=-2)
    gmax = wb.amax(dim=-2)
    span = gmax - gmin
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    s = torch.where(span > 0, div_exact(span, float(INT4_LEVELS)), zero)
    m = gmin
    G = float(group_size)

    def codes(scale, vmin):
        inv = torch.where(scale > 0, rdiv_exact(
            1.0, torch.where(scale > 0, scale, torch.ones_like(scale))), zero)
        return torch.clamp(torch.round((wb - vmin[..., :, None, :])
                                       * inv[..., :, None, :]),
                           0, INT4_LEVELS)

    for _ in range(refine_iters):
        q = codes(s, m)
        # regress w on q per (group, column): minimizes Σ (q·s + m − w)²
        sq = q.sum(dim=-2)
        sq2 = (q * q).sum(dim=-2)
        sw = wb.sum(dim=-2)
        sqw = (q * wb).sum(dim=-2)
        det = G * sq2 - sq * sq          # ≥ 0 (Cauchy–Schwarz); 0 ⇔ const q
        safe = torch.where(det > 0, det, torch.ones_like(det))
        s_new = torch.clamp_min(
            torch.where(det > 0, (G * sqw - sq * sw) / safe, s), 0.0)
        m = torch.where(det > 0, div_exact(sw - s_new * sq, G), m)
        s = s_new
    scale = s.to(scale_dtype)
    vmin = m.to(scale_dtype)
    q = codes(scale.to(torch.float32), vmin.to(torch.float32))
    packed = pack_nibbles(q.reshape(lead + (n_g * group_size, N)))
    return BlockQTensor(data=packed, scale=scale, vmin=vmin,
                        group_size=group_size, k_dim=K)
