"""Plain PyTorch versions of the port's seven kernels (and of K3's two
halves, the accumulator and the epilogue, for a product split on K).

Each ``ref_*`` function computes its kernel's result with plain torch ops at
full (exact integer / float32) precision, mirroring
``repro/kernels/ref.py`` in the form the reference's engine computes it
under ``jax.jit`` (XLA folds a calibrated scale into the weight scales and
rewrites a division by a constant into a multiply by its float32
reciprocal; ``tests/test_torch_jit_forms.py`` counts the sites against the
jitted engine).  Every remaining division is an IEEE division on every
device (``div_exact``/``rdiv_exact``; see ``core/qtensor.py``).  The CPU
path of :mod:`repro_torch.kernels.ops` runs these, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.qtensor import (INV_127, div_exact, rdiv_exact,
                                      unpack_nibbles)

INT8_MAX = 127.0
_EPS = 1e-12

Scale = Union[torch.Tensor, float]


def ref_int8_matmul_accumulate(a_q: torch.Tensor,     # (M, K) int8
                               b_q: torch.Tensor,     # (K, N) int8
                               ) -> torch.Tensor:
    """The exact s32 accumulator ``a_q @ b_q``, (M, N) int32.

    It is formed in float64, where every partial sum of int8 products
    (< 2^53) is an exact integer, so it equals the s32 sum on any device
    while 127² · K < 2^31."""
    acc = torch.matmul(a_q.to(torch.float64), b_q.to(torch.float64))
    return acc.to(torch.int32)


def ref_int8_matmul_epilogue(
    acc: torch.Tensor,             # (M, N) int32
    a_scale: Scale,                # (M, 1) / (1, 1) f32 or a float
    b_scale: torch.Tensor,         # (1, N) f32
    a_zero_point: Optional[Scale] = None,   # scalar (q-space offset)
    colsum: Optional[torch.Tensor] = None,  # (N,) / (1, N) f32 with a zp
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K3's affine epilogue on an s32 accumulator: the int32 -> f32
    conversion, ``(acc - zp · colsum)``, then a tensor activation scale
    (dynamic, per row) multiplies first, ``(acc · a_scale) · b_scale``, and
    a float one (a calibrated constant) is folded into the weight scales
    first, ``acc · (a_scale · b_scale)``, as XLA folds it in the jitted
    engine; ``+ bias`` and the cast last."""
    acc = acc.to(torch.float32)
    if a_zero_point is not None:
        acc = acc - torch.as_tensor(a_zero_point, dtype=torch.float32) \
            * colsum.reshape(1, -1).to(torch.float32)
    if isinstance(a_scale, torch.Tensor):
        out = acc * a_scale * b_scale
    else:
        out = acc * (float(a_scale) * b_scale)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype)


def ref_int8_matmul(
    a_q: torch.Tensor,             # (M, K) int8
    a_scale: Scale,                # (M, 1) / (1, 1) f32 or a float
    b_q: torch.Tensor,             # (K, N) int8
    b_scale: torch.Tensor,         # (1, N) f32
    a_zero_point: Optional[Scale] = None,   # scalar (q-space offset)
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Exact integer accumulation, then the affine epilogue (K3 is
    :func:`ref_int8_matmul_accumulate` then :func:`ref_int8_matmul_epilogue`,
    with the zero-point column sums of ``b_q``)."""
    colsum = (None if a_zero_point is None else
              b_q.to(torch.int32).sum(dim=0).to(torch.float32))
    return ref_int8_matmul_epilogue(ref_int8_matmul_accumulate(a_q, b_q),
                                    a_scale, b_scale, a_zero_point, colsum,
                                    bias, out_dtype)


def ref_int8_matmul_batched(
    a_q: torch.Tensor,             # (E, M, K) int8
    a_scale: Scale,                # (E, M, 1) / (E, 1, 1) f32 or a float
    b_q: torch.Tensor,             # (E, K, N) int8
    b_scale: torch.Tensor,         # (E, 1, N) f32
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Grouped (per-expert) int8 matmul (``repro/kernels/ref.py:48``):
    ``acc[e] = a_q[e] @ b_q[e]`` exactly, then ``acc · a_scale · b_scale``
    in that order, cast to ``out_dtype``.

    As in :func:`ref_int8_matmul`, the accumulator is formed in float64,
    exact on any device (torch has no integer ``bmm`` on CUDA, and float32
    is not exact once 127² · K passes 2^24).
    """
    acc = torch.bmm(a_q.to(torch.float64), b_q.to(torch.float64))
    out = acc.to(torch.float32) * a_scale * b_scale
    return out.to(out_dtype)


def int4_zp_colsum(b_packed: torch.Tensor, b_scale: torch.Tensor,
                   b_min: torch.Tensor, *, group_size: int,
                   k: int) -> torch.Tensor:
    """(1, N) f32 column sums of the dequantized weights over the logical
    ``k`` rows: the zero-point correction of asymmetric activations."""
    nib = unpack_nibbles(b_packed).to(torch.float32)
    deq = (nib * b_scale.to(torch.float32).repeat_interleave(group_size, 0)
           + b_min.to(torch.float32).repeat_interleave(group_size, 0))
    return deq[:k].sum(dim=0, keepdim=True)


def ref_int4_matmul(
    a_q: torch.Tensor,             # (M, K) int8 activations
    a_scale: Scale,                # (M, 1) / (1, 1) f32 or a float
    b_packed: torch.Tensor,        # (K_store//2, N) int8 packed nibbles
    b_scale: torch.Tensor,         # (n_groups, N) f16/f32 block scales
    b_min: torch.Tensor,           # (n_groups, N) f16/f32 block minimums
    a_zero_point: Optional[Scale] = None,   # scalar (q-space offset)
    bias: Optional[torch.Tensor] = None,    # (N,) f32
    *,
    group_size: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Group-wise INT4-weight matmul (``repro/kernels/ref.py:69``).

        real(b)[k, n] = nib[k, n] * scale[k // G, n] + vmin[k // G, n]
        a @ b = a_scale * [ Σ_g (scale_g · (a_q @ nib)_g + vmin_g · rowsum_g)
                            - zp · colsum(real(b)) ] + bias

    Each group's dot and row sum are exact (float64 holds every partial sum
    of int8 × nibble products exactly); the f32 combination runs in
    ascending groups with the reference's op sequence, one rounded op at a
    time.  Activations past ``K`` (up to the stored ``n_groups · G`` rows)
    count as zero, and the zero-point column sum runs over the logical
    ``K`` rows of the dequantized weights only.
    """
    M, K = a_q.shape
    n_g = b_scale.shape[0]
    G = group_size
    k_store = n_g * G
    N = b_packed.shape[1]
    nib = unpack_nibbles(b_packed)                          # (k_store, N)
    a_p = torch.nn.functional.pad(a_q, (0, k_store - K)) if k_store > K \
        else a_q
    a_g = a_p.reshape(M, n_g, G)
    d = torch.matmul(a_g.transpose(0, 1).to(torch.float64),
                     nib.reshape(n_g, G, N).to(torch.float64))  # (n_g, M, N)
    d = d.to(torch.float32)
    rsum = a_g.to(torch.int32).sum(dim=-1).to(torch.float32)    # (M, n_g)
    sc = b_scale.to(torch.float32)
    mn = b_min.to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=a_q.device)
    for g in range(n_g):
        acc = acc + (d[g] * sc[g][None, :] + rsum[:, g:g + 1] * mn[g][None, :])
    if a_zero_point is not None:
        colsum = int4_zp_colsum(b_packed, b_scale, b_min, group_size=G, k=K)
        acc = acc - torch.as_tensor(a_zero_point, dtype=torch.float32) * colsum
    out = acc * a_scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(out_dtype)


def ref_quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric row-wise quantization: (int8, (M, 1) f32 scales).
    The scale is ``amax · float32(1/127)`` and the codes ``round(x / scale)``
    (an IEEE division by a tensor), as the jitted reference computes them."""
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), _EPS)
    scale = amax * INV_127
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def ref_quantize_static(x: torch.Tensor, amax: Scale, *,
                        clamp: bool = True) -> torch.Tensor:
    """Static-scale symmetric quantization (calibrated threshold): the
    codes ``round(x · inv)`` with ``scale = max(amax, eps) / 127`` and
    ``inv = 1 / scale``, both IEEE divisions in float32, as the jitted
    reference computes them (a division by a constant becomes a multiply
    by its reciprocal).  ``clamp`` off takes ``scale = amax / 127``."""
    amax = (amax.to(device=x.device, dtype=torch.float32)
            if isinstance(amax, torch.Tensor)
            else torch.full((), float(amax), device=x.device))
    if clamp:
        amax = torch.clamp_min(amax, _EPS)
    inv = rdiv_exact(1.0, div_exact(amax, INT8_MAX))
    q = torch.clamp(torch.round(x.to(torch.float32) * inv),
                    -INT8_MAX, INT8_MAX)
    return q.to(torch.int8)


def ref_decode_attention(
    q: torch.Tensor,          # (B, H, dh) f32/bf16
    k_q: torch.Tensor,        # (B, S, HKV, dh) int8
    k_scale: torch.Tensor,    # (B, S, HKV) f32
    v_q: torch.Tensor,        # (B, S, HKV, dh) int8
    v_scale: torch.Tensor,    # (B, S, HKV) f32
    lengths: torch.Tensor,    # (B,) int32 valid cache length per sequence
    sm_scale: float,
) -> torch.Tensor:
    """Masked attention of one query token against a dequantized KV cache."""
    B, S, HKV, dh = k_q.shape
    H = q.shape[1]
    G = H // HKV
    k = k_q.to(torch.float32) * k_scale[..., None]
    v = v_q.to(torch.float32) * v_scale[..., None]
    qf = q.to(torch.float32).reshape(B, HKV, G, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k) * sm_scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                   # (B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v)
    return out.reshape(B, H, dh).to(q.dtype)


def ref_decode_attention_paged(
    q: torch.Tensor,              # (B, H, dh) f32/bf16
    k_pages: torch.Tensor,        # (P, ps, HKV, dh) int8 page pool
    k_scale: torch.Tensor,        # (P, ps, HKV) f32
    v_pages: torch.Tensor,        # (P, ps, HKV, dh) int8
    v_scale: torch.Tensor,        # (P, ps, HKV) f32
    block_tables: torch.Tensor,   # (B, maxP) int32 (sentinel = P, clamped)
    lengths: torch.Tensor,        # (B,) int32
    sm_scale: float,
) -> torch.Tensor:
    """Paged version: linearize each row's pages through its clamped block
    table, then run :func:`ref_decode_attention`.  Sentinel entries clamp
    into the pool and are masked by ``lengths``."""
    P = k_pages.shape[0]
    B, maxP = block_tables.shape
    tab = block_tables.long().clamp(0, P - 1)

    def lin(pool):
        got = pool[tab]                           # (B, maxP, ps, …)
        return got.reshape((B, maxP * pool.shape[1]) + tuple(pool.shape[2:]))

    return ref_decode_attention(q, lin(k_pages), lin(k_scale), lin(v_pages),
                                lin(v_scale), lengths, sm_scale)
