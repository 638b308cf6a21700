"""Decoder-only transformer LM (the dense, MoE and VLM-backbone families).

Port of ``repro/models/transformer.py``.  The layers run in an eager Python
loop over unstacked parameters (``blocks.{i}``), so each layer keeps its own
site names; ``checkpoint/bridge.py`` unstacks a scan-stacked reference tree.
Rotary position embeddings, pre-norm blocks, and either the MoE FFN
(``models/moe.py``) or the dense FFN (SwiGLU or GELU, ``models/ffn.py``).

Inputs: ``tokens`` (B, S) int32, right-padded, with optional ``lengths``
(B,); or, for the VLM stub, ``embeds`` (B, S, d_model) precomputed input
embeddings in place of the tokens (cast to the activation dtype).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.distributed.context import run_layers
from repro_torch.models import kv_cache as kvc
from repro_torch.models.attention import attention, attention_init
from repro_torch.models.ffn import ffn, ffn_init
from repro_torch.models.layers import (
    embed,
    embedding_init,
    norm,
    norm_init,
    unembed,
)
from repro_torch.models.moe import moe_ffn, moe_init


class DecoderLM:
    """The model's functions over a parameter dict (the reference's layout).

    ``device`` is where :meth:`init` puts the weights and where the decode
    state lives: ``"cuda"`` unless the caller asks for the CPU.
    """

    def __init__(self, cfg, *, device: str = "cuda"):
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder config")
        self.cfg = cfg
        self.device = torch.device(device)
        # the block nodes the training forward runs through ``run_layers``
        # (the mesh step gathers these a block at a time)
        self.block_keys = [f"blocks.{i}" for i in range(cfg.n_layers)]

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``gen`` (a generator on ``self.device``)."""
        cfg = self.cfg
        kw = dict(dtype=cfg.parameter_dtype, device=self.device)
        params: Dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **kw),
            "final_norm": norm_init(cfg.d_model, cfg.norm, **kw),
        }
        for i in range(cfg.n_layers):
            block = {
                "attn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "attn": attention_init(gen, cfg, **kw),
                "ffn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
            }
            if cfg.moe is not None:
                block["moe"] = moe_init(gen, cfg, **kw)
            else:
                block["ffn"] = ffn_init(gen, cfg, **kw)
            params[f"blocks.{i}"] = block
        return params

    # --------------------------------------------------------------- forward
    def _block_apply(self, bparams, x, *, site, quant, taps, positions,
                     kv_lengths, cache_view=None):
        cfg = self.cfg
        h = norm(bparams["attn_norm"], x, cfg.norm)
        a, entries = attention(
            bparams["attn"], h, cfg=cfg, site=f"{site}/attn", quant=quant,
            taps=taps, positions=positions, kv_lengths=kv_lengths,
            cache=cache_view)
        x = x + a
        h = norm(bparams["ffn_norm"], x, cfg.norm)
        if cfg.moe is not None:
            f, aux = moe_ffn(bparams["moe"], h, cfg=cfg, site=f"{site}/moe",
                             quant=quant, taps=taps)
        else:
            f = ffn(bparams["ffn"], h, cfg=cfg, site=f"{site}/ffn",
                    quant=quant, taps=taps)
            aux = {}
        return x + f, entries, aux

    def _layer(self, bparams, x, **kw):
        """One block of the training forward: (x, aux)."""
        x, _, aux = self._block_apply(bparams, x, **kw)
        return x, aux

    def _inputs(self, params, batch) -> torch.Tensor:
        dt = self.cfg.activation_dtype
        if "embeds" in batch:
            return batch["embeds"].to(dt)
        return embed(params["embed"], batch["tokens"], dt)

    def forward(self, params, batch, *, quant: QuantContext = FP_CONTEXT,
                taps: Optional[Taps] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence forward.  Returns (logits (B, S, V), aux) with the
        load-balance loss summed over the layers.  The blocks run through
        ``distributed.context.run_layers`` (``cfg.remat``, and the
        training mesh's layout)."""
        cfg = self.cfg
        x = self._inputs(params, batch)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        kv_lengths = batch.get("lengths")
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
        x, auxes = run_layers(x, [
            (functools.partial(self._layer, site=key, quant=quant,
                               taps=taps, positions=positions,
                               kv_lengths=kv_lengths), params[key])
            for key in self.block_keys], remat=cfg.remat)
        for aux in auxes:
            if "load_balance_loss" in aux:
                lb = lb + aux["load_balance_loss"]
        x = norm(params["final_norm"], x, cfg.norm)
        return unembed(params["embed"], x), {"load_balance_loss": lb}

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, batch: int, max_len: int, *,
                          quantized: bool) -> Dict[str, Any]:
        """An empty contiguous decode state on ``self.device``."""
        cfg = self.cfg
        return {"cache": kvc.init_cache(
            cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd,
            quantized=quantized, dtype=cfg.activation_dtype,
            device=self.device)}

    def prefill(self, params, batch, state, *,
                quant: QuantContext = FP_CONTEXT
                ) -> Tuple[torch.Tensor, Dict]:
        """Run the prompt, fill the cache, return the logits at each row's
        last valid position (``lengths - 1``).

        The prompt's K/V are written into cache positions [0, S) layer by
        layer (quantized to int8 inside the loop for an INT8 cache), and
        the cursors set to ``lengths``; positions past a row's length hold
        its padding, masked by the cursor and overwritten by decode.
        """
        cfg = self.cfg
        x = self._inputs(params, batch)
        B, S, _ = x.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        lengths = lengths.to(torch.int32)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        cache = state["cache"]
        if S > cache.capacity:
            raise ValueError(f"prompt length {S} exceeds the cache capacity "
                             f"{cache.capacity}")
        for i in range(cfg.n_layers):
            x, (k, v), _ = self._block_apply(
                params[f"blocks.{i}"], x, site=f"blocks.{i}", quant=quant,
                taps=None, positions=positions, kv_lengths=lengths)
            kvc.write_prompt(cache, i, k, v)
        state = dict(state)
        state["cache"] = kvc.with_lengths(cache, lengths)

        x = norm(params["final_norm"], x, cfg.norm)
        idx = torch.clamp_min(lengths - 1, 0).long()
        x_last = x[torch.arange(B, device=x.device), idx]
        return unembed(params["embed"], x_last[:, None, :])[:, 0], state

    def decode_step(self, params, tokens_or_embeds: torch.Tensor, state, *,
                    quant: QuantContext = FP_CONTEXT
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: ``tokens`` (B,) int32, or ``embeds`` (B, 1, D),
        → (logits (B, V), state).  Each row's input is rotated at its
        cursor, its K/V appended there (in place), and the cursors advance
        by one."""
        cfg = self.cfg
        cache = state["cache"]
        if tokens_or_embeds.dim() == 1:
            x = embed(params["embed"], tokens_or_embeds[:, None],
                      cfg.activation_dtype)
        else:
            x = tokens_or_embeds.to(cfg.activation_dtype)
        for i in range(cfg.n_layers):
            x, _, _ = self._block_apply(
                params[f"blocks.{i}"], x, site=f"blocks.{i}", quant=quant,
                taps=None, positions=None, kv_lengths=None,
                cache_view=kvc.layer_view(cache, i))
        state = dict(state)
        state["cache"] = kvc.with_lengths(cache, cache.lengths + 1)
        x = norm(params["final_norm"], x, cfg.norm)
        return unembed(params["embed"], x)[:, 0], state
