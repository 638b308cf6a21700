"""Encoder-decoder transformer: the paper's Transformer NMT model.

Port of ``repro/models/encdec.py`` (``init``, ``encode``, ``forward``,
``init_decode_state`` over a contiguous or paged cache, ``encode_cross_kv``,
``splice_prefill``, ``prefill``, ``decode_step(_multi)`` and the staged
encode of chunked prefill, ``encode_staged_begin``/``_layer``/``_finish``).
The layers run in an eager Python loop over unstacked parameters
(``enc_blocks.{i}`` / ``dec_blocks.{i}``), so each layer keeps its own site
names; ``checkpoint/bridge.py`` unstacks a scan-stacked reference tree.

Cross-attention K/V are computed once from the encoder memory and kept in
the decode state.  Inputs: ``src_tokens`` (B, S_enc), or the audio stub's
``src_embeds`` (B, S_enc, d_model) frame embeddings, with optional
``src_lengths``; ``tgt_tokens`` (B, S_dec) for teacher forcing.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.distributed.context import run_layers
from repro_torch.models import kv_cache as kvc
from repro_torch.models.attention import attention, attention_init
from repro_torch.models.ffn import ffn, ffn_init
from repro_torch.models.layers import (
    block_input,
    dense,
    embed,
    embedding_init,
    norm,
    norm_init,
    unembed,
)


@functools.lru_cache(maxsize=16)
def _sinusoid_table(S: int, D: int) -> torch.Tensor:
    """Float32 table computed on the host, so every device gets its values."""
    pos = torch.arange(S, dtype=torch.float32)[:, None]
    dim = torch.arange(0, D, 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(10000.0, dim / D)
    pe = torch.zeros((S, D), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angle)          # even columns: sin
    pe[:, 1::2] = torch.cos(angle)          # odd columns: cos
    return pe


@functools.lru_cache(maxsize=16)
def _sinusoid_on(S: int, D: int, dtype: torch.dtype,
                 device: str) -> torch.Tensor:
    return _sinusoid_table(S, D).to(device=device, dtype=dtype)


def sinusoidal_positions(S: int, D: int, dtype,
                         device=None) -> torch.Tensor:
    return _sinusoid_on(S, D, dtype, str(torch.device(device or "cpu")))


class EncDecLM:
    """The model's functions over a parameter dict (the reference's layout).

    ``device`` is where :meth:`init` puts the weights and where the decode
    state lives: ``"cuda"`` unless the caller asks for the CPU.
    """

    def __init__(self, cfg, *, device: str = "cuda"):
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.device = torch.device(device)
        # the block nodes the training forward runs through ``run_layers``
        # (the mesh step gathers these a block at a time)
        self.enc_keys = [f"enc_blocks.{i}" for i in range(cfg.n_enc_layers)]
        self.dec_keys = [f"dec_blocks.{i}" for i in range(cfg.n_layers)]
        self.block_keys = self.enc_keys + self.dec_keys

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``gen`` (a generator on ``self.device``)."""
        cfg = self.cfg
        kw = dict(dtype=cfg.parameter_dtype, device=self.device)
        params: Dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **kw),
            "enc_final_norm": norm_init(cfg.d_model, cfg.norm, **kw),
            "dec_final_norm": norm_init(cfg.d_model, cfg.norm, **kw),
        }
        for i in range(cfg.n_enc_layers):
            params[f"enc_blocks.{i}"] = {
                "attn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "attn": attention_init(gen, cfg, **kw),
                "ffn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "ffn": ffn_init(gen, cfg, **kw),
            }
        for i in range(cfg.n_layers):
            params[f"dec_blocks.{i}"] = {
                "self_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "self_attn": attention_init(gen, cfg, **kw),
                "cross_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "cross_attn": attention_init(gen, cfg, **kw),
                "ffn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "ffn": ffn_init(gen, cfg, **kw),
            }
        return params

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token embedding scaled by √d in the activation dtype: as in JAX,
        the Python scalar √d is first rounded to that dtype."""
        cfg = self.cfg
        dt = cfg.activation_dtype
        x = embed(params["embed"], tokens, dt)
        return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))

    # ---------------------------------------------------------------- encode
    # The encoder is bidirectional, so a long source cannot be encoded
    # token chunk by token chunk; chunked prefill splits it by depth
    # instead: embed once, one encoder layer per serving round, then the
    # final norm and the cross-K/V projections.  ``encode`` and
    # ``encode_cross_kv`` are built from the same three stages, so a staged
    # encode equals the monolithic one bit for bit.
    def encode_staged_begin(self, params, batch) -> torch.Tensor:
        """Embedding and positions: the encoder's input ``x``.  The audio
        stub's ``src_embeds`` (B, S_enc, D) frame embeddings are taken as
        given (cast to the activation dtype, not scaled by √d)."""
        if "src_embeds" in batch:
            x = batch["src_embeds"].to(self.cfg.activation_dtype)
        else:
            x = self._embed(params, batch["src_tokens"])
        _, S, D = x.shape
        return x + sinusoidal_positions(S, D, x.dtype, x.device)[None]

    def encode_staged_layer(self, params, x: torch.Tensor, layer_idx: int, *,
                            src_lengths: Optional[torch.Tensor] = None,
                            quant: QuantContext = FP_CONTEXT,
                            taps: Optional[Taps] = None) -> torch.Tensor:
        """Encoder layer ``layer_idx`` (quant sites ``enc_blocks.{i}/…``)."""
        return self._enc_block(
            params[f"enc_blocks.{layer_idx}"], x,
            site=f"enc_blocks.{layer_idx}", src_lengths=src_lengths,
            quant=quant, taps=taps)[0]

    def _enc_block(self, bp, x, *, site, src_lengths, quant, taps):
        cfg = self.cfg
        h = norm(bp["attn_norm"], x, cfg.norm)
        a, _ = attention(bp["attn"], h, cfg=cfg, site=f"{site}/attn",
                         quant=quant, taps=taps, causal=False, rope=False,
                         kv_lengths=src_lengths)
        x = x + a
        h = norm(bp["ffn_norm"], x, cfg.norm)
        return x + ffn(bp["ffn"], h, cfg=cfg, site=f"{site}/ffn",
                       quant=quant, taps=taps), None

    def encode_staged_finish(self, params, x: torch.Tensor, *,
                             src_lengths: Optional[torch.Tensor] = None,
                             quant: QuantContext = FP_CONTEXT
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """Final norm and every decoder layer's cross K/V: returns
        ``(cross_k, cross_v, src_lengths)``, cross K/V layer-major
        ``(L, B, S_enc, HKV, dh)``."""
        cfg = self.cfg
        memory = norm(params["enc_final_norm"], x, cfg.norm)
        B, S = memory.shape[0], memory.shape[1]
        if src_lengths is None:
            src_lengths = torch.full((B,), S, dtype=torch.int32,
                                     device=memory.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            k, v = self._cross_kv(params[f"dec_blocks.{i}"], memory,
                                  site=f"dec_blocks.{i}", quant=quant,
                                  taps=None)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs), src_lengths

    def _encode_layers(self, params, batch, *, quant, taps) -> torch.Tensor:
        """The encoder's blocks through ``distributed.context.run_layers``
        (``cfg.remat``, the training mesh's layout); the stream whole."""
        x = self.encode_staged_begin(params, batch)
        x, _ = run_layers(x, [
            (functools.partial(self._enc_block, site=key,
                               src_lengths=batch.get("src_lengths"),
                               quant=quant, taps=taps), params[key])
            for key in self.enc_keys], remat=self.cfg.remat)
        return x

    def encode(self, params, batch, *, quant: QuantContext = FP_CONTEXT,
               taps: Optional[Taps] = None) -> torch.Tensor:
        x = self._encode_layers(params, batch, quant=quant, taps=taps)
        return norm(params["enc_final_norm"], x, self.cfg.norm)

    # ---------------------------------------------------------------- decode
    def _dec_block(self, bparams, x, memory, *, site, quant, taps, positions,
                   kv_lengths, memory_lengths, cache_view=None):
        cfg = self.cfg
        h = norm(bparams["self_norm"], x, cfg.norm)
        a, entries = attention(
            bparams["self_attn"], h, cfg=cfg, site=f"{site}/self_attn",
            quant=quant, taps=taps, positions=positions,
            kv_lengths=kv_lengths, cache=cache_view, rope=False)
        x = x + a
        h = norm(bparams["cross_norm"], x, cfg.norm)
        c, _ = attention(
            bparams["cross_attn"], h, cfg=cfg, site=f"{site}/cross_attn",
            quant=quant, taps=taps, memory=memory,
            memory_lengths=memory_lengths,
            per_query=cache_view is not None)
        x = x + c
        h = norm(bparams["ffn_norm"], x, cfg.norm)
        f = ffn(bparams["ffn"], h, cfg=cfg, site=f"{site}/ffn", quant=quant,
                taps=taps)
        return x + f, entries

    def _cross_kv(self, bparams, memory, *, site, quant, taps):
        """Project encoder memory to this layer's cross K/V (done once).
        The memory is whole on every rank, also inside a block on a
        sequence-split residual."""
        cfg = self.cfg
        B, S, _ = memory.shape
        memory = block_input(memory, bparams["cross_attn"]["o_proj"],
                             whole=True)
        k = dense(bparams["cross_attn"]["k_proj"], memory,
                  site=f"{site}/cross_attn/k_proj", quant=quant,
                  taps=taps).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        v = dense(bparams["cross_attn"]["v_proj"], memory,
                  site=f"{site}/cross_attn/v_proj", quant=quant,
                  taps=taps).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        return k, v

    def forward(self, params, batch, *, quant: QuantContext = FP_CONTEXT,
                taps: Optional[Taps] = None) -> Tuple[torch.Tensor, Dict]:
        """Teacher-forced forward: returns decoder logits (B, S_dec, V)."""
        cfg = self.cfg
        memory = self.encode(params, batch, quant=quant, taps=taps)
        mem_lengths = batch.get("src_lengths")
        x = self._embed(params, batch["tgt_tokens"])
        B, S, D = x.shape
        x = x + sinusoidal_positions(S, D, x.dtype, x.device)[None]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        x, _ = run_layers(x, [
            (functools.partial(self._dec_layer, memory=memory, site=key,
                               quant=quant, taps=taps, positions=positions,
                               kv_lengths=batch.get("tgt_lengths"),
                               memory_lengths=mem_lengths), params[key])
            for key in self.dec_keys], remat=cfg.remat)
        x = norm(params["dec_final_norm"], x, cfg.norm)
        return unembed(params["embed"], x), {}

    def _dec_layer(self, bp, x, *, memory, site, quant, taps, **kw):
        """One decoder block of the training forward, its cross K/V
        projected inside it (so ``remat`` recomputes them)."""
        kv = self._cross_kv(bp, memory, site=site, quant=quant, taps=taps)
        return self._dec_block(bp, x, kv, site=site, quant=quant, taps=taps,
                               **kw)[0], None

    # ------------------------------------------------------- serving states
    def init_decode_state(self, batch: int, max_len: int, *, quantized: bool,
                          enc_len: Optional[int] = None, paged: bool = False,
                          page_size: int = 16,
                          n_pages: Optional[int] = None) -> Dict[str, Any]:
        """An empty decode state on ``self.device``.

        ``enc_len``: allocate cross K/V buffers of that length (continuous
        serving splices admitted rows into them).  ``paged=True`` backs the
        self-attention cache with a page pool and block tables
        (``kv_cache.PagedKVCache``); rows own no pages until
        :meth:`splice_prefill` assigns a reservation.  ``n_pages`` bounds
        the pool (default: contiguous-equivalent capacity).
        """
        cfg = self.cfg
        dt = cfg.activation_dtype
        if paged:
            cache = kvc.init_paged_cache(
                cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd,
                page_size=page_size, n_pages=n_pages, quantized=quantized,
                dtype=dt, device=self.device)
        else:
            cache = kvc.init_cache(cfg.n_layers, batch, max_len,
                                   cfg.n_kv_heads, cfg.hd,
                                   quantized=quantized, dtype=dt,
                                   device=self.device)
        state: Dict[str, Any] = {"cache": cache, "cross_k": None,
                                 "cross_v": None, "src_lengths": None}
        if enc_len is not None:
            shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
            state["cross_k"] = torch.zeros(shape, dtype=dt,
                                           device=self.device)
            state["cross_v"] = torch.zeros(shape, dtype=dt,
                                           device=self.device)
            state["src_lengths"] = torch.full((batch,), enc_len,
                                              dtype=torch.int32,
                                              device=self.device)
        return state

    def encode_cross_kv(self, params, batch, *,
                        quant: QuantContext = FP_CONTEXT
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Run the encoder and project every decoder layer's cross K/V
        (:meth:`encode_staged_finish`)."""
        x = self._encode_layers(params, batch, quant=quant, taps=None)
        return self.encode_staged_finish(
            params, x, src_lengths=batch.get("src_lengths"), quant=quant)

    def splice_prefill(self, state: Dict[str, Any], cross_k: torch.Tensor,
                       cross_v: torch.Tensor, src_lengths: torch.Tensor,
                       base_rows, *, group: int = 1,
                       pages=None) -> Dict[str, Any]:
        """Splice an :meth:`encode_cross_kv` result into decode-state rows.

        ``base_rows``: (B_sub,) host destination rows, one per encoded
        source; with ``group > 1`` each source goes to the ``group`` rows
        ``[base, base + group)``.  Out-of-range bases are padding and are
        dropped.  The cross K/V are written in place.  The self-attention
        rows are not copied: their cursors reset to 0, which masks every
        stale position, so the next decode step on a spliced row equals a
        step on a fresh side batch.  Paged cache: ``pages`` (host,
        (len(rows), maxP)) carries each row's page reservation
        (``kv_cache.assign_pages``).
        """
        rows = kvc.group_rows(base_rows, group)
        ck, cv, sl = state["cross_k"], state["cross_v"], state["src_lengths"]
        keep, dst = kvc.in_range_rows(rows, sl.shape[0])
        src = torch.as_tensor(keep // group, device=ck.device)
        dst = torch.as_tensor(dst, device=ck.device)
        ck[:, dst] = cross_k[:, src].to(ck.dtype)
        cv[:, dst] = cross_v[:, src].to(cv.dtype)
        out = dict(state)
        out["src_lengths"] = sl.index_put((dst,),
                                          src_lengths[src].to(torch.int32))
        cache = state["cache"]
        if isinstance(cache, kvc.PagedKVCache):
            if pages is None:
                raise ValueError("paged splice_prefill needs the spliced "
                                 "rows' page reservations")
            out["cache"] = kvc.assign_pages(cache, rows, pages)
        else:
            out["cache"] = kvc.free_slots(cache, rows)
        return out

    def prefill(self, params, batch, state, *,
                quant: QuantContext = FP_CONTEXT) -> Tuple[torch.Tensor, Dict]:
        """Encode the source, keep its cross K/V, emit the BOS-step logits."""
        ck, cv, src_lengths = self.encode_cross_kv(params, batch, quant=quant)
        state = dict(state)
        state["cross_k"], state["cross_v"] = ck, cv
        state["src_lengths"] = src_lengths
        bos = torch.zeros((ck.shape[1],), dtype=torch.int32, device=ck.device)
        return self.decode_step(params, bos, state, quant=quant)

    def decode_step(self, params, tokens, state, *,
                    quant: QuantContext = FP_CONTEXT) -> Tuple[torch.Tensor, Dict]:
        """Single-token decode: ``tokens`` (B,) → (logits (B, V), state)."""
        logits, state = self.decode_step_multi(params, tokens[:, None], state,
                                               quant=quant)
        return logits[:, 0], state

    def decode_step_multi(self, params, tokens, state, *,
                          quant: QuantContext = FP_CONTEXT
                          ) -> Tuple[torch.Tensor, Dict]:
        """Decode ``T`` consecutive positions per row in one pass.

        ``tokens``: (B, T); position t of row b is embedded at cursor
        ``lengths[b] + t`` and causally masked to its own prefix.  The cache
        is written in place and the returned state's cursors advance by T.
        """
        cfg = self.cfg
        cache = state["cache"]
        T = tokens.shape[1]
        x = self._embed(params, tokens)
        pe = sinusoidal_positions(cache.capacity, cfg.d_model, x.dtype,
                                  x.device)
        # rows stepping past their cursor (finished, still in the batch)
        # read the last position instead of out of bounds
        pos = torch.clamp(cache.lengths[:, None]
                          + torch.arange(T, dtype=torch.int32,
                                         device=x.device)[None, :],
                          max=cache.capacity - 1)
        x = x + pe[pos.long()]
        paged = isinstance(cache, kvc.PagedKVCache)
        # a paged view holds the layer's whole store, sink page included
        k, v, ks, vs = ((cache.k_store, cache.v_store, cache.ks_store,
                         cache.vs_store) if paged else
                        (cache.k, cache.v, cache.k_scale, cache.v_scale))
        for i in range(cfg.n_layers):
            view = kvc.LayerCacheView(
                k=k[i], v=v[i],
                k_scale=None if ks is None else ks[i],
                v_scale=None if vs is None else vs[i],
                lengths=cache.lengths,
                block_tables=cache.block_tables if paged else None)
            x, _ = self._dec_block(
                params[f"dec_blocks.{i}"], x,
                (state["cross_k"][i], state["cross_v"][i]),
                site=f"dec_blocks.{i}", quant=quant, taps=None,
                positions=None, kv_lengths=None,
                memory_lengths=state["src_lengths"], cache_view=view)
        state = dict(state)
        state["cache"] = kvc.with_lengths(cache, cache.lengths + T)
        x = norm(params["dec_final_norm"], x, cfg.norm)
        return unembed(params["embed"], x), state
