"""Multi-head / grouped-query attention with prefill + decode paths.

Port of ``repro/models/attention.py``.  Prefill and training use a
chunked attention written out in plain torch — matmul, mask, float32
softmax — over query chunks.  Decode appends the
step's K/V to the cache and then, for an INT8 cache, reads it through
``kernels.ops.decode_attention`` (K4, contiguous) or
``kernels.ops.decode_attention_paged`` (K5, paged).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kvc
from repro_torch.models.layers import (
    apply_rope,
    block_input,
    block_output,
    dense,
    dense_init,
)

NEG_INF = -1e30


def attention_init(gen: torch.Generator, cfg, *, dtype=torch.float32,
                   device=None):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(bias=cfg.attn_bias, dtype=dtype, device=device)
    return {
        "q_proj": dense_init(gen, d, h * hd, **kw),
        "k_proj": dense_init(gen, d, hkv * hd, **kw),
        "v_proj": dense_init(gen, d, hkv * hd, **kw),
        "o_proj": dense_init(gen, h * hd, d, **kw),
    }


# ---------------------------------------------------------------------------
# chunked full attention (train / prefill / cross-attention)
# ---------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,                 # (B, Sq, H, dh)
    k: torch.Tensor,                 # (B, Sk, HKV, dh)
    v: torch.Tensor,                 # (B, Sk, HKV, dh)
    *,
    causal: bool,
    q_positions: Optional[torch.Tensor] = None,   # (B, Sq) global positions
    kv_lengths: Optional[torch.Tensor] = None,    # (B,) valid kv length
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Scores and probabilities in float32 over the activation-dtype q/k/v
    (the reference's bf16 operands with f32 accumulation)."""
    B, Sq, H, dh = q.shape
    _, Sk, HKV, _ = k.shape
    G = H // HKV
    sm_scale = 1.0 / math.sqrt(dh)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32,
                                   device=dev).expand(B, Sq)
    k_positions = torch.arange(Sk, dtype=torch.int32, device=dev)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    kf = k.to(torch.float32).permute(0, 2, 3, 1)             # (B, H, dh, Sk)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)             # (B, H, Sk, dh)

    outs = []
    for c0 in range(0, Sq, q_chunk):
        q_c = q[:, c0:c0 + q_chunk]                          # (B, C, H, dh)
        pos_c = q_positions[:, c0:c0 + q_chunk]              # (B, C)
        C = q_c.shape[1]
        scores = torch.matmul(q_c.to(torch.float32).permute(0, 2, 1, 3),
                              kf) * sm_scale                 # (B, H, C, Sk)
        mask = torch.ones((B, C, Sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos_c[:, :, None] >= k_positions[None, None, :]
        if kv_lengths is not None:
            mask &= k_positions[None, None, :] < kv_lengths[:, None, None]
        scores = torch.where(mask[:, None], scores,
                             torch.full((), NEG_INF, device=dev))
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs.to(q.dtype).to(torch.float32), vf)
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))     # (B, C, H, dh)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attention(
    params,
    x: torch.Tensor,                     # (B, S, D)
    *,
    cfg,
    site: str,
    quant: QuantContext = FP_CONTEXT,
    taps: Optional[Taps] = None,
    positions: Optional[torch.Tensor] = None,      # (B, S)
    kv_lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    rope: bool = True,
    cache: Optional[kvc.LayerCacheView] = None,
    memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    memory_lengths: Optional[torch.Tensor] = None,
    per_query: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Returns (output, new_cache_entries).

    * ``cache is None and memory is None`` — train/prefill self-attention;
    * ``cache is not None`` — decode: the S new positions are appended at the
      cursor (in place), then each query position j attends its own causal
      prefix with the single-query kernel at lengths ``cursor + j + 1``;
    * ``memory is not None`` — cross-attention onto precomputed (k, v).

    ``rope``: rotate q and k by their positions (the decoder-only family;
    the enc-dec family passes False).  Decode positions come from the
    cache cursor, ``lengths + [0, S)``; train and prefill positions are
    ``positions`` or ``arange(S)``.
    """
    H, HKV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    # tensor parallel, GQA fallback: this rank's query heads read a slice
    # of the whole kv heads (distributed.collectives.HeadSlice)
    hs = params.get("tp")
    x = block_input(x, params["o_proj"])
    B, S, _ = x.shape

    q = dense(params["q_proj"], x, site=f"{site}/q_proj", quant=quant,
              taps=taps).reshape(B, S, H, dh)

    if memory is not None:
        k, v = _heads(memory[0], hs), _heads(memory[1], hs)
        if per_query and S > 1:
            out = torch.cat(
                [chunked_attention(q[:, j:j + 1], k, v, causal=False,
                                   kv_lengths=memory_lengths)
                 for j in range(S)], dim=1)
        else:
            out = chunked_attention(q, k, v, causal=False,
                                    kv_lengths=memory_lengths)
        out = out.reshape(B, S, H * dh)
        y = dense(params["o_proj"], out, site=f"{site}/o_proj", quant=quant,
                  taps=taps)
        return block_output(y), None

    k = dense(params["k_proj"], x, site=f"{site}/k_proj", quant=quant,
              taps=taps).reshape(B, S, HKV, dh)
    v = dense(params["v_proj"], x, site=f"{site}/v_proj", quant=quant,
              taps=taps).reshape(B, S, HKV, dh)

    if rope:
        pos = positions
        if pos is None:
            steps = torch.arange(S, dtype=torch.int32, device=x.device)
            pos = (cache.lengths[:, None] + steps[None, :]
                   if cache is not None else steps.expand(B, S))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    if cache is not None:
        tables = cache.block_tables
        if tables is not None:
            k_c, v_c, ks_c, vs_c = kvc.append_tokens_paged(
                cache.k, cache.v, cache.k_scale, cache.v_scale, tables, k, v,
                cache.lengths)
            # reads see the pool without its sink page
            pool = lambda a: None if a is None else a[:-1]
            k_r, v_r, ks_r, vs_r = pool(k_c), pool(v_c), pool(ks_c), \
                pool(vs_c)
            if ks_c is None:
                # FP paged: linearize the pool through the table and reuse
                # the contiguous math, as the reference does (no kernel)
                k_r = kvc.linearize_pages(k_r, tables)
                v_r = kvc.linearize_pages(v_r, tables)
        else:
            k_c, v_c, ks_c, vs_c = kvc.append_tokens(
                cache.k, cache.v, cache.k_scale, cache.v_scale, k, v,
                cache.lengths)
            k_r, v_r, ks_r, vs_r = k_c, v_c, ks_c, vs_c
        k_r, v_r, ks_r, vs_r = (_heads(a, hs) for a in (k_r, v_r, ks_r, vs_r))
        sm_scale = 1.0 / math.sqrt(dh)
        outs = []
        for j in range(S):
            q1 = q[:, j].reshape(B, H, dh)
            lengths = cache.lengths + (j + 1)
            if ks_c is not None and tables is not None:
                o = ops.decode_attention_paged(
                    q1, k_r, ks_r, v_r, vs_r, tables, lengths,
                    sm_scale=sm_scale, impl=quant.impl)
            elif ks_c is not None:
                o = ops.decode_attention(q1, k_r, ks_r, v_r, vs_r, lengths,
                                         sm_scale=sm_scale, impl=quant.impl)
            else:
                o = _fp_decode_attention(q1, k_r, v_r, lengths, sm_scale)
            outs.append(o)
        out = torch.stack(outs, dim=1).reshape(B, S, H * dh)
        y = dense(params["o_proj"], out, site=f"{site}/o_proj", quant=quant,
                  taps=taps)
        return y, (k_c, v_c, ks_c, vs_c)

    out = chunked_attention(q, _heads(k, hs), _heads(v, hs), causal=causal,
                            q_positions=positions, kv_lengths=kv_lengths)
    out = out.reshape(B, S, H * dh)
    y = dense(params["o_proj"], out, site=f"{site}/o_proj", quant=quant,
              taps=taps)
    return block_output(y), (k, v)


def _heads(t: Optional[torch.Tensor], hs) -> Optional[torch.Tensor]:
    """Kv heads ``[hs.lo, hs.lo + hs.n)`` of a (..., HKV, dh) tensor or a
    (..., HKV) scale (axis 2 of either), as a contiguous copy the kernels
    can read; everything with no ``HeadSlice``.  The copy is the GQA
    fallback's cost: a layer's whole cache a decode step."""
    if hs is None or t is None:
        return t
    return t.narrow(2, hs.lo, hs.n).contiguous()


def _fp_decode_attention(q, k, v, lengths, sm_scale):
    """Float-cache decode path (the baseline without the paper's technique)."""
    B, H, dh = q.shape
    _, Sk, HKV, _ = k.shape
    G = H // HKV
    qf = q.to(torch.float32).reshape(B, HKV, G, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.to(torch.float32))
    scores = scores * sm_scale
    mask = torch.arange(Sk, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.to(torch.float32))
    return out.reshape(B, H, dh).to(q.dtype)
