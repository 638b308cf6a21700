"""s8·s8→s32 matmul with the dequantize epilogue fused (K3), and its
per-expert grouped form (K7), on the card.

Ports of ``repro/kernels/int8_matmul.py:int8_matmul_pallas`` and
``:int8_matmul_batched_pallas``.  Both run the kernel in
``csrc/int8_matmul.cu`` (K7 with the expert as a third grid axis); these
wrappers check their inputs, compute the zero-point column sums (as the
reference's wrapper does, outside the kernel, and only for asymmetric
activations), allocate the output, launch on the current stream and count
the launch.  The plain versions are ``ref.ref_int8_matmul`` and
``ref.ref_int8_matmul_batched``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import build

OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device, kernel: str = "int8_matmul") -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def int8_matmul_cuda(
    a_q: torch.Tensor,                      # (M, K) int8
    a_scale: Union[torch.Tensor, float],    # (M, 1) / (1, 1) f32, or a float
    b_q: torch.Tensor,                      # (K, N) int8
    b_scale: torch.Tensor,                  # (1, N) f32
    a_zero_point: Optional[float] = None,   # q-space offset
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    *,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    if not a_q.is_cuda:
        raise ValueError(f"int8_matmul: needs CUDA tensors, got {a_q.device}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a_q.shape)} x "
                         f"{tuple(b_q.shape)} do not multiply")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_matmul: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    M, K = a_q.shape
    N = b_q.shape[1]
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (M, K), dev)
    _check(b_q, "b_q", torch.int8, (K, N), dev)
    _check(b_scale, "b_scale", torch.float32, (1, N), dev)
    a_scale_ptr, a_scale_value, per_row = None, 0.0, 0
    if isinstance(a_scale, torch.Tensor):
        per_row = int(a_scale.numel() != 1)
        _check(a_scale, "a_scale", torch.float32, (M, 1) if per_row else (1, 1),
               dev)
        a_scale_ptr = a_scale.data_ptr()
    else:
        a_scale_value = float(a_scale)
    colsum_ptr, zp = None, 0.0
    if a_zero_point is not None:
        zp = float(a_zero_point)
        colsum = b_q.to(torch.int32).sum(dim=0).to(torch.float32)
        colsum_ptr = colsum.data_ptr()
    if bias is not None:
        _check(bias, "bias", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        err = build.lib().repro_int8_matmul(
            a_q.data_ptr(), b_q.data_ptr(), a_scale_ptr, a_scale_value,
            per_row, b_scale.data_ptr(), colsum_ptr, zp,
            int(a_zero_point is not None),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, OUT_DTYPES[out_dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "int8_matmul")
        build.LAUNCHES["int8_matmul"] += 1
    return out


MAX_EXPERTS = 65535          # the grid's z extent


def int8_matmul_batched_cuda(
    a_q: torch.Tensor,                      # (E, M, K) int8
    a_scale: Union[torch.Tensor, float],    # (E, M, 1) / (1, 1, 1) f32, float
    b_q: torch.Tensor,                      # (E, K, N) int8
    b_scale: torch.Tensor,                  # (E, 1, N) f32
    *,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K7: ``out[e] = (a_q[e] @ b_q[e]) · a_scale[e] · b_scale[e]``."""
    kernel = "int8_matmul_batched"
    if not a_q.is_cuda:
        raise ValueError(f"{kernel}: needs CUDA tensors, got {a_q.device}")
    if (a_q.dim() != 3 or b_q.dim() != 3 or a_q.shape[0] != b_q.shape[0]
            or a_q.shape[2] != b_q.shape[1]):
        raise ValueError(f"{kernel}: shapes {tuple(a_q.shape)} x "
                         f"{tuple(b_q.shape)} do not multiply per expert")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{kernel}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    E, M, K = a_q.shape
    N = b_q.shape[2]
    if E > MAX_EXPERTS:
        raise ValueError(f"{kernel}: at most {MAX_EXPERTS} experts, got {E}")
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (E, M, K), dev, kernel)
    _check(b_q, "b_q", torch.int8, (E, K, N), dev, kernel)
    _check(b_scale, "b_scale", torch.float32, (E, 1, N), dev, kernel)
    a_scale_ptr, a_scale_value, per_row = None, 0.0, 0
    if isinstance(a_scale, torch.Tensor):
        per_row = int(a_scale.numel() != 1)
        _check(a_scale, "a_scale", torch.float32,
               (E, M, 1) if per_row else (1, 1, 1), dev, kernel)
        a_scale_ptr = a_scale.data_ptr()
    else:
        a_scale_value = float(a_scale)
    out = torch.empty((E, M, N), dtype=out_dtype, device=dev)
    if out.numel():
        err = build.lib().repro_int8_matmul_batched(
            a_q.data_ptr(), b_q.data_ptr(), a_scale_ptr, a_scale_value,
            per_row, b_scale.data_ptr(), out.data_ptr(), E, M, N, K,
            OUT_DTYPES[out_dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, kernel)
        build.LAUNCHES[kernel] += 1
    return out
