"""zamba2-style hybrid: a Mamba2 backbone and one SHARED attention + FFN
block applied every ``attn_every`` layers.

Port of ``repro/models/hybrid.py`` (its unstacked layout: ``mamba.{i}``
and ``shared``).  The shared block has one set of parameters, reused at
each application, and each application has its own KV cache at decode
time: the caches are stacked one per application, (n_apps, B, S, HKV,
dh), and a decode step reads application ``a``'s through a
``LayerCacheView`` (K4 for an INT8 cache).

The decode state is ``{"ssm": SSMState(h (L, B, H, N, P), conv (L, B, W-1,
d_inner)), "cache": KVCache}``; prefill and decode write it in place, as
``DecoderLM`` writes its cache.  As in the reference, ``prefill`` runs the
Mamba2 layers over all ``S`` positions, so a right-padded row's state
absorbs its pad positions, and the logits are read at ``lengths - 1``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
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
from repro_torch.models.ssm import (
    SSMState,
    _dims,
    ssm_block,
    ssm_decode_step,
    ssm_init,
)


class HybridLM:
    """The model's functions over a parameter dict (the reference's
    unstacked layout), on ``device``."""

    # the decode state keeps rows off axis 0 (SSMState is (L, B, ...)):
    # the reference's beam reorder and serve fail on it (serving/engine.py)
    recurrent = True

    def __init__(self, cfg, *, device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.every = cfg.hybrid.attn_every
        self.n_apps = cfg.n_layers // self.every

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``gen`` (a generator on ``self.device``)."""
        cfg = self.cfg
        kw = dict(dtype=cfg.parameter_dtype, device=self.device)
        params: Dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **kw),
            "final_norm": norm_init(cfg.d_model, cfg.norm, **kw),
            "shared": {
                "attn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "attn": attention_init(gen, cfg, **kw),
                "ffn_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                "ffn": ffn_init(gen, cfg, **kw),
            },
        }
        for i in range(cfg.n_layers):
            params[f"mamba.{i}"] = ssm_init(gen, cfg, **kw)
        return params

    def _shared_block(self, params, x, *, quant, taps, positions, kv_lengths,
                      cache_view=None):
        cfg = self.cfg
        sp = params["shared"]
        h = norm(sp["attn_norm"], x, cfg.norm)
        a, entries = attention(sp["attn"], h, cfg=cfg, site="shared/attn",
                               quant=quant, taps=taps, positions=positions,
                               kv_lengths=kv_lengths, cache=cache_view)
        x = x + a
        h = norm(sp["ffn_norm"], x, cfg.norm)
        x = x + ffn(sp["ffn"], h, cfg=cfg, site="shared/ffn", quant=quant,
                    taps=taps)
        return x, entries

    def _is_attn(self, i: int) -> bool:
        return (i + 1) % self.every == 0

    # --------------------------------------------------------------- forward
    def forward(self, params, batch, *, quant: QuantContext = FP_CONTEXT,
                taps: Optional[Taps] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.activation_dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        lengths = batch.get("lengths")
        for i in range(cfg.n_layers):
            y, _ = ssm_block(params[f"mamba.{i}"], x, cfg=cfg,
                             site=f"blocks.{i}/mamba", quant=quant,
                             taps=taps)
            x = x + y
            if self._is_attn(i):
                x, _ = self._shared_block(params, x, quant=quant, taps=taps,
                                          positions=positions,
                                          kv_lengths=lengths)
        x = norm(params["final_norm"], x, cfg.norm)
        return unembed(params["embed"], x), {}

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, batch: int, max_len: int, *,
                          quantized: bool) -> Dict[str, Any]:
        """Zero SSM states and an empty stacked cache on ``self.device``."""
        cfg = self.cfg
        s, d_inner, H = _dims(cfg)
        ssm = SSMState(
            h=torch.zeros((cfg.n_layers, batch, H, s.state, s.head_dim),
                          dtype=torch.float32, device=self.device),
            conv=torch.zeros((cfg.n_layers, batch, s.conv_width - 1,
                              d_inner), dtype=cfg.activation_dtype,
                             device=self.device))
        cache = kvc.init_cache(self.n_apps, batch, max_len, cfg.n_kv_heads,
                               cfg.hd, quantized=quantized,
                               dtype=cfg.activation_dtype,
                               device=self.device)
        return {"ssm": ssm, "cache": cache}

    def prefill(self, params, batch, state, *,
                quant: QuantContext = FP_CONTEXT
                ) -> Tuple[torch.Tensor, Dict]:
        """Run the prompt, write each layer's SSM state and each
        application's K/V (positions [0, S)) into ``state``, set the
        cursors to ``lengths``; return the logits at ``lengths - 1``."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.activation_dtype)
        B, S, _ = x.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        lengths = lengths.to(torch.int32)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        cache, ssm = state["cache"], state["ssm"]
        if S > cache.capacity:
            raise ValueError(f"prompt length {S} exceeds the cache capacity "
                             f"{cache.capacity}")
        app = 0
        for i in range(cfg.n_layers):
            y, st = ssm_block(params[f"mamba.{i}"], x, cfg=cfg,
                              site=f"blocks.{i}/mamba", quant=quant,
                              return_state=True)
            x = x + y
            ssm.h[i].copy_(st.h)
            ssm.conv[i].copy_(st.conv)
            if self._is_attn(i):
                x, (k, v) = self._shared_block(
                    params, x, quant=quant, taps=None, positions=positions,
                    kv_lengths=lengths)
                kvc.write_prompt(cache, app, k, v)
                app += 1
        state = dict(state)
        state["cache"] = kvc.with_lengths(cache, lengths)

        x = norm(params["final_norm"], x, cfg.norm)
        idx = torch.clamp_min(lengths - 1, 0).long()
        x_last = x[torch.arange(B, device=x.device), idx]
        return unembed(params["embed"], x_last[:, None, :])[:, 0], state

    def decode_step(self, params, tokens: torch.Tensor, state, *,
                    quant: QuantContext = FP_CONTEXT
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: ``tokens`` (B,) int32 → (logits (B, V), state),
        the SSM states updated and each application's K/V appended at the
        cursor in place, the cursors advanced by one."""
        cfg = self.cfg
        cache, ssm = state["cache"], state["ssm"]
        x = embed(params["embed"], tokens[:, None], cfg.activation_dtype)
        app = 0
        for i in range(cfg.n_layers):
            y, st = ssm_decode_step(
                params[f"mamba.{i}"], x, SSMState(h=ssm.h[i],
                                                  conv=ssm.conv[i]),
                cfg=cfg, site=f"blocks.{i}/mamba", quant=quant)
            x = x + y
            ssm.h[i].copy_(st.h)
            ssm.conv[i].copy_(st.conv)
            if self._is_attn(i):
                x, _ = self._shared_block(params, x, quant=quant, taps=None,
                                          positions=None, kv_lengths=None,
                                          cache_view=kvc.layer_view(cache,
                                                                    app))
                app += 1
        state = dict(state)
        state["cache"] = kvc.with_lengths(cache, cache.lengths + 1)
        x = norm(params["final_norm"], x, cfg.norm)
        return unembed(params["embed"], x)[:, 0], state
