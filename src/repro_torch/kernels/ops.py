"""Public wrappers around the port's kernels (mirrors ``repro/kernels/ops.py``).

Every op dispatches on ``impl``:

* ``"cuda"``  — the hand-written kernel; the tensors must be on a CUDA
                device, or the op raises;
* ``"torch"`` — the plain PyTorch version (``kernels/ref.py``), on any
                device;
* ``"auto"``  — the kernel for CUDA tensors, the plain version for CPU
                tensors (and only for those).

The wrappers are QTensor/BlockQTensor-aware and flatten leading batch
dimensions, so model code stays shape-agnostic.  ``launch_counts()``
reports how many times each kernel was launched since
``reset_launch_counts()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.qtensor import BlockQTensor, QTensor
from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda,
    decode_attention_paged_cuda,
)
from repro_torch.kernels.int4_matmul import int4_matmul_cuda
from repro_torch.kernels.int8_matmul import (
    int8_matmul_accumulate_cuda,
    int8_matmul_batched_cuda,
    int8_matmul_cuda,
    int8_matmul_epilogue_cuda,
)
from repro_torch.kernels.quantize import (
    quantize_rowwise_cuda,
    quantize_static_cuda,
)

IMPLS = ("auto", "cuda", "torch")


def launch_counts() -> Dict[str, int]:
    with build.LAUNCH_LOCK:
        return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    with build.LAUNCH_LOCK:
        for name in build.LAUNCHES:
            build.LAUNCHES[name] = 0


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """True → launch the CUDA kernel, False → run the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "torch":
        return False
    if x.is_cuda:
        return True
    if impl == "cuda" or x.device.type != "cpu":
        raise ValueError(f"impl={impl!r} has no kernel for a tensor on "
                         f"{x.device}; the CUDA kernels need CUDA tensors")
    return False


# ---------------------------------------------------------------------------
# int8 matmul
# ---------------------------------------------------------------------------

def _row_scale(scale, M: int):
    """Normalize an activation scale to a float, (1, 1) or (M, 1) f32."""
    if not isinstance(scale, torch.Tensor):
        return float(scale)
    scale = scale.to(torch.float32)
    return scale.reshape(1, 1) if scale.numel() == 1 else scale.reshape(M, 1)


def _fold_zero_point(zero_point) -> Optional[float]:
    """Symmetric activations have zp == 0: fold to the no-zp path."""
    if isinstance(zero_point, torch.Tensor):
        if zero_point.numel() != 1:
            raise ValueError("int8_matmul: activation zero point must be a "
                             f"scalar, got shape {tuple(zero_point.shape)}")
        zero_point = zero_point.item()
    return None if float(zero_point) == 0.0 else float(zero_point)


def int8_matmul(
    a: QTensor,
    b: QTensor,
    bias: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> torch.Tensor:
    """``dequant(a) @ dequant(b) + bias`` computed in int8.

    ``a``: activations (..., K), scale per row (..., 1) or scalar;
    ``b``: weights (K, N), symmetric per-column scale (1, N) or scalar.
    """
    batch_shape = a.data.shape[:-1]
    K = a.data.shape[-1]
    N = b.data.shape[-1]
    a2 = a.data.reshape(-1, K)
    M = a2.shape[0]
    a_scale = _row_scale(a.scale, M)
    b_scale = torch.as_tensor(b.scale, dtype=torch.float32,
                              device=b.data.device)
    b_scale = (b_scale.reshape(1, 1).expand(1, N) if b_scale.numel() == 1
               else b_scale.reshape(1, N))
    zp = _fold_zero_point(a.zero_point)
    if use_kernel(impl, a2):
        out = int8_matmul_cuda(
            a2.contiguous(), a_scale, b.data.contiguous(),
            b_scale.contiguous(), zp, bias, out_dtype=out_dtype)
    else:
        out = ref.ref_int8_matmul(a2, a_scale, b.data, b_scale, zp, bias,
                                  out_dtype=out_dtype)
    return out.reshape(*batch_shape, N)


def int8_matmul_accumulate(a_q: torch.Tensor, b_q: torch.Tensor, *,
                           impl: str = "auto") -> torch.Tensor:
    """The exact s32 ``a_q @ b_q`` of int8 codes (..., K) × (K, N), with no
    epilogue: one rank's share of a product split on K."""
    batch_shape = a_q.shape[:-1]
    K = a_q.shape[-1]
    N = b_q.shape[-1]
    a2 = a_q.reshape(-1, K)
    if use_kernel(impl, a2):
        acc = int8_matmul_accumulate_cuda(a2.contiguous(), b_q.contiguous())
    else:
        acc = ref.ref_int8_matmul_accumulate(a2, b_q)
    return acc.reshape(*batch_shape, N)


def int8_matmul_epilogue(
    acc: torch.Tensor,
    a_scale,
    b_scale: torch.Tensor,
    a_zero_point=0.0,
    colsum: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> torch.Tensor:
    """K3's epilogue on an s32 accumulator (..., N): ``(acc - zp·colsum) ·
    a_scale · b_scale + bias``, as :func:`int8_matmul` computes it.
    ``a_scale`` per row (..., 1) or scalar; ``b_scale`` (1, N) or scalar;
    ``colsum`` (N,): the weight codes' column sums over the whole K, needed
    with a nonzero zero point."""
    batch_shape = acc.shape[:-1]
    N = acc.shape[-1]
    acc2 = acc.reshape(-1, N)
    M = acc2.shape[0]
    a_scale = _row_scale(a_scale, M)
    b_scale = torch.as_tensor(b_scale, dtype=torch.float32,
                              device=acc.device)
    b_scale = (b_scale.reshape(1, 1).expand(1, N) if b_scale.numel() == 1
               else b_scale.reshape(1, N))
    zp = _fold_zero_point(a_zero_point)
    if zp is not None:
        colsum = colsum.reshape(N).to(torch.float32)
    if use_kernel(impl, acc2):
        out = int8_matmul_epilogue_cuda(
            acc2.contiguous(), a_scale, b_scale.contiguous(), zp,
            None if zp is None else colsum.contiguous(), bias,
            out_dtype=out_dtype)
    else:
        out = ref.ref_int8_matmul_epilogue(acc2, a_scale, b_scale, zp,
                                           colsum, bias, out_dtype=out_dtype)
    return out.reshape(*batch_shape, N)


def int8_matmul_batched(
    a: QTensor,
    b: QTensor,
    *,
    out_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> torch.Tensor:
    """Per-expert grouped int8 matmul (the MoE expert FFN's hot path).

    ``a``: activations (E, M, K), scale (E, M, 1) or a scalar;
    ``b``: weights (E, K, N), symmetric per-column scale (E, 1, N).
    Returns ``dequant(a[e]) @ dequant(b[e])`` for every expert, (E, M, N).
    """
    E, M, _ = a.data.shape
    N = b.data.shape[-1]
    a_scale = a.scale
    if isinstance(a_scale, torch.Tensor):
        a_scale = a_scale.to(torch.float32)
        a_scale = (a_scale.reshape(1, 1, 1) if a_scale.numel() == 1
                   else a_scale.expand(E, M, 1).contiguous())
    else:
        a_scale = float(a_scale)
    b_scale = torch.as_tensor(b.scale, dtype=torch.float32,
                              device=b.data.device).reshape(E, 1, N)
    if use_kernel(impl, a.data):
        return int8_matmul_batched_cuda(
            a.data.contiguous(), a_scale, b.data.contiguous(),
            b_scale.contiguous(), out_dtype=out_dtype)
    return ref.ref_int8_matmul_batched(a.data, a_scale, b.data, b_scale,
                                       out_dtype=out_dtype)


def int4_matmul(
    a: QTensor,
    b: BlockQTensor,
    bias: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> torch.Tensor:
    """``dequant(a) @ block_dequant(b) + bias``, dequantized in the kernel.

    ``a``: int8 activations (..., K), scale per row (..., 1) or scalar;
    ``b``: block-quantized INT4 weights (packed nibbles + group scale/min).
    """
    batch_shape = a.data.shape[:-1]
    K = a.data.shape[-1]
    if b.data.dim() != 2:
        raise ValueError(f"int4_matmul wants 2-D weights, got {b.shape}")
    if K != b.k_dim:
        raise ValueError(f"K mismatch: activations {K}, weights {b.k_dim}")
    N = b.data.shape[-1]
    a2 = a.data.reshape(-1, K)
    M = a2.shape[0]
    a_scale = _row_scale(a.scale, M)
    zp = _fold_zero_point(a.zero_point)
    if use_kernel(impl, a2):
        out = int4_matmul_cuda(
            a2.contiguous(), a_scale, b.data.contiguous(),
            b.scale.contiguous(), b.vmin.contiguous(), zp, bias,
            group_size=b.group_size, out_dtype=out_dtype)
    else:
        out = ref.ref_int4_matmul(a2, a_scale, b.data, b.scale, b.vmin, zp,
                                  bias, group_size=b.group_size,
                                  out_dtype=out_dtype)
    return out.reshape(*batch_shape, N)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def quantize_rowwise(x: torch.Tensor, *, impl: str = "auto") -> QTensor:
    """Dynamic symmetric per-row quantization of (..., K) activations."""
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel(impl, x2):
        q, scale = quantize_rowwise_cuda(x2.contiguous())
    else:
        q, scale = ref.ref_quantize_rowwise(x2)
    return QTensor(data=q.reshape(x.shape), scale=scale.reshape(*batch_shape, 1),
                   zero_point=0.0, axis=None)


def quantize_static(x: torch.Tensor, amax: float, *, impl: str = "auto",
                    clamp: bool = True) -> QTensor:
    """Calibrated symmetric quantization with a constant threshold.

    The returned scale is ``float32(amax) / 127`` without the kernel's eps
    clamp, exactly as the reference's ``ops.quantize_static`` returns it.
    The codes take the threshold clamped at 1e-12, as the reference's
    kernel does; ``clamp=False`` takes it as it is (the MoE expert sites).
    """
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel(impl, x2):
        q = quantize_static_cuda(x2.contiguous(), amax, clamp=clamp)
    else:
        q = ref.ref_quantize_static(x2, float(np.float32(amax)), clamp=clamp)
    scale = float(np.float32(amax) / np.float32(127.0))
    return QTensor(data=q.reshape(x.shape), scale=scale, zero_point=0.0,
                   axis=None)


# ---------------------------------------------------------------------------
# decode attention over an int8 KV cache
# ---------------------------------------------------------------------------

def decode_attention(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float,
    impl: str = "auto",
) -> torch.Tensor:
    if use_kernel(impl, q):
        return decode_attention_cuda(
            q.contiguous(), k_q.contiguous(), k_scale.contiguous(),
            v_q.contiguous(), v_scale.contiguous(),
            lengths.to(torch.int32).contiguous(), sm_scale=sm_scale)
    return ref.ref_decode_attention(q, k_q, k_scale, v_q, v_scale, lengths,
                                    sm_scale)


def decode_attention_paged(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    k_scale: torch.Tensor,
    v_pages: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float,
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention over a paged INT8 cache: the kernel walks each
    row's block table in place; the plain version linearizes the table and
    reuses the contiguous one."""
    if use_kernel(impl, q):
        return decode_attention_paged_cuda(
            q.contiguous(), k_pages.contiguous(), k_scale.contiguous(),
            v_pages.contiguous(), v_scale.contiguous(),
            block_tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(), sm_scale=sm_scale)
    return ref.ref_decode_attention_paged(q, k_pages, k_scale, v_pages,
                                          v_scale, block_tables, lengths,
                                          sm_scale)
