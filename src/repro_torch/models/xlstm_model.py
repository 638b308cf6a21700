"""xLSTM LM (the ssm family): a pre-norm residual stack of mLSTM blocks
with an sLSTM block every ``slstm_every`` layers (the xLSTM paper's [7:1]
mix).

Port of ``repro/models/xlstm_model.py`` (its unstacked layout,
``blocks.{i}``).  The decode state is laid out as the reference's:
``{"mlstm": MLSTMState (G, M, B, ...), "slstm": SLSTMState (G, B, ...),
"lengths"}`` with G groups of M = slstm_every - 1 mLSTM layers and one
sLSTM layer; prefill and decode write it in place.  As in the reference,
``prefill`` runs every layer over all ``S`` positions (a right-padded
row's state absorbs its pad positions) and reads the logits at
``lengths - 1``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.models.layers import (
    embed,
    embedding_init,
    norm,
    norm_init,
    unembed,
)
from repro_torch.models.xlstm import (
    NEG_INIT,
    MLSTMState,
    SLSTMState,
    _dims,
    mlstm_block,
    mlstm_decode_step,
    mlstm_init,
    slstm_block,
    slstm_decode_step,
    slstm_init,
)


def _write(dst, src) -> None:
    """Copy a state's fields into another's (in place)."""
    for d, s in zip(dst, src):
        d.copy_(s)


class XLSTMLM:
    """The model's functions over a parameter dict (the reference's
    unstacked layout), on ``device``."""

    # the decode state keeps rows off axis 0 (groups first): the
    # reference's beam reorder and serve fail on it (serving/engine.py)
    recurrent = True

    def __init__(self, cfg, *, device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.every = cfg.xlstm.slstm_every
        if cfg.n_layers % self.every:
            raise ValueError(f"n_layers {cfg.n_layers} must divide by "
                             f"slstm_every {self.every}")
        self.n_groups = cfg.n_layers // self.every
        self.m_per_group = self.every - 1

    def _is_slstm(self, i: int) -> bool:
        return (i + 1) % self.every == 0

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
            block = slstm_init if self._is_slstm(i) else mlstm_init
            params[f"blocks.{i}"] = {
                "pre_norm": norm_init(cfg.d_model, cfg.norm, **kw),
                **block(gen, cfg, **kw)}
        return params

    def _block(self, i, bp, x, *, quant, taps, return_state=False):
        h = norm(bp["pre_norm"], x, self.cfg.norm)
        if self._is_slstm(i):
            return slstm_block(bp, h, cfg=self.cfg, site=f"blocks.{i}/slstm",
                               quant=quant, taps=taps,
                               return_state=return_state)
        return mlstm_block(bp, h, cfg=self.cfg, site=f"blocks.{i}/mlstm",
                           quant=quant, taps=taps, return_state=return_state)

    # --------------------------------------------------------------- forward
    def forward(self, params, batch, *, quant: QuantContext = FP_CONTEXT,
                taps: Optional[Taps] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.activation_dtype)
        for i in range(cfg.n_layers):
            y, _ = self._block(i, params[f"blocks.{i}"], x, quant=quant,
                               taps=taps)
            x = x + y
        x = norm(params["final_norm"], x, cfg.norm)
        return unembed(params["embed"], x), {}

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, batch: int, max_len: int, *,
                          quantized: bool) -> Dict[str, Any]:
        """Empty recurrent states on ``self.device`` (``max_len`` and
        ``quantized`` have nothing to size: the state is O(1) in length)."""
        d_inner, H, dh = _dims(self.cfg)
        G, M = self.n_groups, self.m_per_group
        f32 = dict(dtype=torch.float32, device=self.device)
        return {
            "mlstm": MLSTMState(
                C=torch.zeros((G, M, batch, H, dh, dh), **f32),
                n=torch.zeros((G, M, batch, H, dh), **f32),
                m=torch.full((G, M, batch, H), NEG_INIT, **f32)),
            "slstm": SLSTMState(
                c=torch.zeros((G, batch, d_inner), **f32),
                n=torch.zeros((G, batch, d_inner), **f32),
                h=torch.zeros((G, batch, d_inner), **f32),
                m=torch.full((G, batch, d_inner), NEG_INIT, **f32)),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device),
        }

    def _layer_state(self, state, i: int):
        """Layer ``i``'s state: views into the stacked tensors."""
        g, j = divmod(i, self.every)
        if self._is_slstm(i):
            return SLSTMState(*(a[g] for a in state["slstm"]))
        return MLSTMState(*(a[g, j] for a in state["mlstm"]))

    def prefill(self, params, batch, state, *,
                quant: QuantContext = FP_CONTEXT
                ) -> Tuple[torch.Tensor, Dict]:
        """Run the prompt from empty states, write each layer's final state
        into ``state``, set ``lengths``; return the logits at
        ``lengths - 1``."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.activation_dtype)
        B, S, _ = x.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        for i in range(cfg.n_layers):
            y, st = self._block(i, params[f"blocks.{i}"], x, quant=quant,
                                taps=None, return_state=True)
            _write(self._layer_state(state, i), st)
            x = x + y
        state = dict(state)
        state["lengths"] = lengths.to(torch.int32)

        x = norm(params["final_norm"], x, cfg.norm)
        idx = torch.clamp_min(lengths - 1, 0).long()
        x_last = x[torch.arange(B, device=x.device), idx]
        return unembed(params["embed"], x_last[:, None, :])[:, 0], state

    def decode_step(self, params, tokens: torch.Tensor, state, *,
                    quant: QuantContext = FP_CONTEXT
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: ``tokens`` (B,) int32 → (logits (B, V), state),
        every layer's state updated in place, ``lengths`` advanced."""
        cfg = self.cfg
        x = embed(params["embed"], tokens[:, None], cfg.activation_dtype)
        for i in range(cfg.n_layers):
            bp = params[f"blocks.{i}"]
            h = norm(bp["pre_norm"], x, cfg.norm)
            st = self._layer_state(state, i)
            step, kind = ((slstm_decode_step, "slstm") if self._is_slstm(i)
                          else (mlstm_decode_step, "mlstm"))
            y, st2 = step(bp, h, st, cfg=cfg, site=f"blocks.{i}/{kind}",
                          quant=quant)
            _write(st, st2)
            x = x + y
        state = dict(state)
        state["lengths"] = state["lengths"] + 1
        x = norm(params["final_norm"], x, cfg.norm)
        return unembed(params["embed"], x)[:, 0], state
