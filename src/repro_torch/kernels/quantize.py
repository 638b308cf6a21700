"""Activation quantizers on the card: K1 (calibrated) and K2 (dynamic).

Ports of ``repro/kernels/quantize.py``.  The kernels are in
``csrc/quantize.cu``; these wrappers check their inputs, allocate the
outputs, launch on the current stream and count the launch.  The plain
versions are ``ref.ref_quantize_static`` / ``ref.ref_quantize_rowwise``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_rows(x: torch.Tensor, kernel: str) -> None:
    """A kernel input of shape (M, K): CUDA, f32/bf16, contiguous."""
    if not x.is_cuda:
        raise ValueError(f"{kernel}: needs a CUDA tensor, got {x.device}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{kernel}: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{kernel}: x must be 2-D (M, K), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: x must be contiguous")


def quantize_static_cuda(x: torch.Tensor, amax: float) -> torch.Tensor:
    """``clip(rint(x / (max(amax, 1e-12) / 127)), ±127)`` as int8 (M, K)."""
    check_rows(x, "quantize_static")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    if q.numel():
        err = build.lib().repro_quantize_static(
            x.data_ptr(), q.data_ptr(), M, K, float(amax), X_DTYPES[x.dtype],
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "quantize_static")
        build.LAUNCHES["quantize_static"] += 1
    return q


def quantize_rowwise_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row abs-max quantizer: (int8 (M, K), f32 scales (M, 1))."""
    check_rows(x, "quantize_rowwise")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if q.numel():
        err = build.lib().repro_quantize_rowwise(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
            X_DTYPES[x.dtype], x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "quantize_rowwise")
        build.LAUNCHES["quantize_rowwise"] += 1
    return q, scale
