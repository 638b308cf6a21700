"""KV cache with an optional INT8 payload (paper §5.3): the contiguous half of
``repro/models/kv_cache.py`` (the paged cache is not ported yet).

Keeping the cache int8 (per-token per-head symmetric scales, computed when
the token is appended) cuts the bytes every decode step reads, and that a
beam reorder moves, 4× against f32.

Unlike the reference's immutable arrays, the appends here write into the
cache tensors in place: a decode step then allocates no new cache.  Callers
hand the cache on and do not reuse the old one, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.qtensor import div_exact

INT8_MAX = 127.0
_EPS = 1e-12


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity cache for one attention stack (layers stacked).

    ``k``/``v``: (L, B, S_max, HKV, dh) int8 or activation dtype.
    ``k_scale``/``v_scale``: (L, B, S_max, HKV) f32, or None (fp cache).
    ``lengths``: (B,) int32 valid lengths / per-sequence write cursors.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_cache(n_layers: int, batch: int, max_len: int, n_kv: int, dh: int,
               *, quantized: bool, dtype=torch.bfloat16,
               device=None) -> KVCache:
    shape = (n_layers, batch, max_len, n_kv, dh)
    if quantized:
        k = torch.zeros(shape, dtype=torch.int8, device=device)
        v = torch.zeros(shape, dtype=torch.int8, device=device)
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    else:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = vs = None
    return KVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token per-head symmetric quantization: (…, dh) → int8 + scale.

    IEEE division and round-half-to-even, so the codes equal the
    reference's bit for bit."""
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1), _EPS)
    scale = div_exact(amax, INT8_MAX)
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class LayerCacheView:
    """One layer's slice, as consumed by attention: ``k``/``v`` are
    (B, S, HKV, dh) views into the stacked cache."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor      # (B,)


def _put(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``cache[b, pos[b]] = new[b]`` in place, for rows with ``pos < S``.

    Rows at or past capacity write nowhere (the reference's ``mode="drop"``
    scatter): their clamped slot is rewritten with its own old value, so
    no row's cursor is read on the host.
    """
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    live = (pos < S).reshape((B,) + (1,) * (new.dim() - 1))
    slot = pos.clamp(max=S - 1).long()
    cache[rows, slot] = torch.where(live, new.to(cache.dtype),
                                    cache[rows, slot])


def append_tokens(
    k_cache: torch.Tensor,               # (B, S_max, HKV, dh)
    v_cache: torch.Tensor,
    ks_cache: Optional[torch.Tensor],
    vs_cache: Optional[torch.Tensor],
    k_new: torch.Tensor,                 # (B, T, HKV, dh) fp
    v_new: torch.Tensor,
    lengths: torch.Tensor,               # (B,) per-sequence cursors
):
    """Write ``T`` consecutive tokens per row starting at its cursor (in
    place): row b's token t lands at ``lengths[b] + t``; any position at or
    past capacity writes nowhere."""
    if ks_cache is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
    for t in range(k_new.shape[1]):
        pos = lengths + t
        if ks_cache is not None:
            _put(k_cache, kq[:, t], pos)
            _put(v_cache, vq[:, t], pos)
            _put(ks_cache, ks[:, t], pos)
            _put(vs_cache, vs[:, t], pos)
        else:
            _put(k_cache, k_new[:, t], pos)
            _put(v_cache, v_new[:, t], pos)
    return k_cache, v_cache, ks_cache, vs_cache


def append_token(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new, lengths):
    """One new token per sequence at its own cursor (``k_new``: (B, 1, …))."""
    return append_tokens(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new,
                         lengths)


def gather_beams(cache: KVCache, beam_idx: torch.Tensor) -> KVCache:
    """Beam-search cache reorder along batch — the paper's GatherNd.

    ``beam_idx``: (B,) source rows.  On an int8 cache this moves 4× fewer
    bytes than f32 (2× vs bf16).
    """
    idx = beam_idx.long()
    take = lambda a: None if a is None else a.index_select(1, idx)
    return KVCache(k=take(cache.k), v=take(cache.v),
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale),
                   lengths=cache.lengths.index_select(0, idx))
