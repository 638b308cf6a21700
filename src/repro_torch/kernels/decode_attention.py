"""Flash-decode attention over an INT8 KV cache on the card: contiguous
(K4) and paged (K5).

Port of ``repro/kernels/decode_attention.py:decode_attention_pallas`` and
``decode_attention_paged_pallas``.  Both kernels are in
``csrc/decode_attention.cu``; each wrapper checks its inputs, allocates the
output, launches on the current stream and counts the launch.  The plain
versions are ``ref.ref_decode_attention`` and
``ref.ref_decode_attention_paged``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024      # static launch limit without an opt-in attribute


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"decode_attention: {name} is on {t.device}, "
                         f"not {device}")
    if t.dtype != dtype:
        raise TypeError(f"decode_attention: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_attention: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_attention: {name} must be contiguous")


def decode_attention_cuda(
    q: torch.Tensor,          # (B, H, dh) f32/bf16
    k_q: torch.Tensor,        # (B, S, HKV, dh) int8
    k_scale: torch.Tensor,    # (B, S, HKV) f32
    v_q: torch.Tensor,        # (B, S, HKV, dh) int8
    v_scale: torch.Tensor,    # (B, S, HKV) f32
    lengths: torch.Tensor,    # (B,) int32
    *,
    sm_scale: float,
) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f"decode_attention: needs CUDA tensors, got {q.device}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, dh) and k_q "
                         f"(B, S, HKV, dh), got {tuple(q.shape)}, "
                         f"{tuple(k_q.shape)}")
    B, H, dh = q.shape
    _, S, HKV, _ = k_q.shape
    if H % HKV:
        raise ValueError(f"decode_attention: {H} heads over {HKV} kv heads")
    G = H // HKV
    dev = q.device
    _check(q, "q", q.dtype, (B, H, dh), dev)
    _check(k_q, "k_q", torch.int8, (B, S, HKV, dh), dev)
    _check(v_q, "v_q", torch.int8, (B, S, HKV, dh), dev)
    _check(k_scale, "k_scale", torch.float32, (B, S, HKV), dev)
    _check(v_scale, "v_scale", torch.float32, (B, S, HKV), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    lib = build.lib()
    if lib.repro_decode_attention_smem_bytes(G, dh) > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: G={G}, dh={dh} needs more than "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        err = lib.repro_decode_attention(
            q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, S, HKV, G, dh, float(sm_scale), Q_DTYPES[q.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "decode_attention")
        build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_paged_cuda(
    q: torch.Tensor,             # (B, H, dh) f32/bf16
    k_pages: torch.Tensor,       # (P, ps, HKV, dh) int8 page pool
    k_scale: torch.Tensor,       # (P, ps, HKV) f32
    v_pages: torch.Tensor,       # (P, ps, HKV, dh) int8
    v_scale: torch.Tensor,       # (P, ps, HKV) f32
    block_tables: torch.Tensor,  # (B, maxP) int32; sentinel P = unreserved
    lengths: torch.Tensor,       # (B,) int32
    *,
    sm_scale: float,
) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f"decode_attention_paged: needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"decode_attention_paged: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"decode_attention_paged: q must be (B, H, dh), "
                         f"k_pages (P, ps, HKV, dh) and block_tables "
                         f"(B, maxP), got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, "
                         f"{tuple(block_tables.shape)}")
    B, H, dh = q.shape
    P, ps, HKV, _ = k_pages.shape
    maxP = block_tables.shape[1]
    if H % HKV:
        raise ValueError(f"decode_attention_paged: {H} heads over {HKV} kv "
                         f"heads")
    G = H // HKV
    dev = q.device
    _check(q, "q", q.dtype, (B, H, dh), dev)
    _check(k_pages, "k_pages", torch.int8, (P, ps, HKV, dh), dev)
    _check(v_pages, "v_pages", torch.int8, (P, ps, HKV, dh), dev)
    _check(k_scale, "k_scale", torch.float32, (P, ps, HKV), dev)
    _check(v_scale, "v_scale", torch.float32, (P, ps, HKV), dev)
    _check(block_tables, "block_tables", torch.int32, (B, maxP), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    lib = build.lib()
    if lib.repro_decode_attention_paged_smem_bytes(G, dh, maxP) > _SMEM_LIMIT:
        raise ValueError(f"decode_attention_paged: G={G}, dh={dh}, "
                         f"maxP={maxP} needs more than {_SMEM_LIMIT} bytes "
                         f"of shared memory")
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        err = lib.repro_decode_attention_paged(
            q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
            v_pages.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, P, ps, maxP, HKV, G, dh,
            float(sm_scale), Q_DTYPES[q.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "decode_attention_paged")
        build.LAUNCHES["decode_attention_paged"] += 1
    return out
