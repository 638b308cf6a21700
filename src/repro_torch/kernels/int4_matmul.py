"""s8 activations × block-wise INT4 weights with the dequantize epilogue
fused (K6), on the card.

Port of ``repro/kernels/int4_matmul.py:int4_matmul_pallas``.  The kernel is
in ``csrc/int4_matmul.cu``; this wrapper checks its inputs, computes the
zero-point column sums of the dequantized weights (as the reference's
wrapper does, outside the kernel, and only for asymmetric activations),
allocates the output, launches on the current stream and counts the launch.
The plain version is ``ref.ref_int4_matmul``.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_matmul import OUT_DTYPES
from repro_torch.kernels.int8_matmul import _check as _check_tensor

SCALE_DTYPES = {torch.float32: 0, torch.float16: 1}
_check = functools.partial(_check_tensor, kernel="int4_matmul")


def int4_matmul_cuda(
    a_q: torch.Tensor,                      # (M, K) int8
    a_scale: Union[torch.Tensor, float],    # (M, 1) / (1, 1) f32, or a float
    b_packed: torch.Tensor,                 # (K_store // 2, N) int8 nibbles
    b_scale: torch.Tensor,                  # (n_groups, N) f16/f32
    b_min: torch.Tensor,                    # (n_groups, N), b_scale's dtype
    a_zero_point: Optional[float] = None,   # q-space offset
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    *,
    group_size: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    if not a_q.is_cuda:
        raise ValueError(f"int4_matmul: needs CUDA tensors, got {a_q.device}")
    if a_q.dim() != 2 or b_packed.dim() != 2 or b_scale.dim() != 2:
        raise ValueError("int4_matmul: a_q, b_packed and b_scale must be 2-D")
    if group_size < 2 or group_size % 2:
        raise ValueError(f"int4_matmul: group_size must be even and >= 2, "
                         f"got {group_size}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int4_matmul: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if b_scale.dtype not in SCALE_DTYPES:
        raise TypeError(f"int4_matmul: scales must be float16 or float32, "
                        f"got {b_scale.dtype}")
    M, K = a_q.shape
    n_g, N = b_scale.shape
    k_store = n_g * group_size
    if tuple(b_packed.shape) != (k_store // 2, N):
        raise ValueError(f"int4_matmul: packed weights {tuple(b_packed.shape)}"
                         f" do not hold {n_g} groups of {group_size} rows "
                         f"x {N}")
    if K > k_store:
        raise ValueError(f"int4_matmul: activation K={K} exceeds the stored "
                         f"K={k_store}")
    dev = a_q.device
    _check(a_q, "a_q", torch.int8, (M, K), dev)
    _check(b_packed, "b_packed", torch.int8, (k_store // 2, N), dev)
    _check(b_scale, "b_scale", b_scale.dtype, (n_g, N), dev)
    _check(b_min, "b_min", b_scale.dtype, (n_g, N), dev)
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
        colsum = ref.int4_zp_colsum(b_packed, b_scale, b_min,
                                    group_size=group_size, k=K).reshape(N)
        colsum_ptr = colsum.data_ptr()
    if bias is not None:
        _check(bias, "bias", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        err = build.lib().repro_int4_matmul(
            a_q.data_ptr(), b_packed.data_ptr(), a_scale_ptr, a_scale_value,
            per_row, b_scale.data_ptr(), b_min.data_ptr(),
            SCALE_DTYPES[b_scale.dtype], colsum_ptr, zp,
            int(a_zero_point is not None),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, n_g, group_size, OUT_DTYPES[out_dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "int4_matmul")
        build.LAUNCHES["int4_matmul"] += 1
    return out
