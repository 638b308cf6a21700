"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro/models/xlstm.py``.

* **mLSTM** is linear-attention-like: a state ``C (dk, dv)`` with an
  exponential input gate and a log-sigmoid forget gate, stabilised by a
  running log-max ``m``.  :func:`mlstm_block` runs it chunked (within a
  chunk an attention-like product against a decay matrix, the stabiliser
  ``b = max(m, cummax a)``; a Python loop over chunks carries (C, n, m));
  :func:`mlstm_block_sequential` steps it position by position, the
  reference's own oracle for the chunked form.
* **sLSTM** has a per-channel scalar state and head-block recurrent
  weights; it steps through time.

The q/k/v/up/down and sLSTM input projections are ``layers.dense`` sites
(INT8 on K1/K2 + K3 when quantized; ``gate_ssm_if`` is on the policy's
deny list); every recurrence runs in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.models.layers import dense, dense_init, layernorm, norm_init
from repro_torch.models.ssm import softplus

NEG_INIT = -1e30     # the stabiliser of an empty state


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, dk, dv) float32
    n: torch.Tensor    # (B, H, dk) float32
    m: torch.Tensor    # (B, H) float32 — log stabiliser


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, d_inner) float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def _dims(cfg):
    d_inner = 2 * cfg.d_model
    H = cfg.n_heads
    return d_inner, H, d_inner // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, *, dtype=torch.float32,
               device=None):
    d = cfg.d_model
    d_inner, H, _ = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "up_proj": dense_init(gen, d, 2 * d_inner, **kw),
        "q_proj": dense_init(gen, d_inner, d_inner, **kw),
        "k_proj": dense_init(gen, d_inner, d_inner, **kw),
        "v_proj": dense_init(gen, d_inner, d_inner, **kw),
        "gate_ssm_if": dense_init(gen, d_inner, 2 * H, bias=True, **kw),
        "down_proj": dense_init(gen, d_inner, d, **kw),
        "norm": norm_init(d_inner, "layernorm", **kw),
    }


def _mlstm_qkvg(params, x, *, site, quant, taps, cfg):
    d_inner, H, dh = _dims(cfg)
    B, S, _ = x.shape
    up = dense(params["up_proj"], x, site=f"{site}/up_proj", quant=quant,
               taps=taps)
    xi, z = up[..., :d_inner], up[..., d_inner:]
    q = dense(params["q_proj"], xi, site=f"{site}/q_proj", quant=quant,
              taps=taps).reshape(B, S, H, dh)
    # k / sqrt(dh) as the reference's jitted form computes it: times the
    # float32 reciprocal of the float32 root
    inv = float(np.float32(1.0) / np.float32(math.sqrt(float(dh))))
    k = dense(params["k_proj"], xi, site=f"{site}/k_proj", quant=quant,
              taps=taps).reshape(B, S, H, dh) * inv
    v = dense(params["v_proj"], xi, site=f"{site}/v_proj", quant=quant,
              taps=taps).reshape(B, S, H, dh)
    gates = dense(params["gate_ssm_if"], xi, site=f"{site}/gate_ssm_if",
                  quant=quant, taps=taps).to(torch.float32)
    i_raw, f_raw = gates[..., :H], gates[..., H:]               # (B, S, H)
    return q, k, v, i_raw, f_raw, z


def _mlstm_step(state: MLSTMState, q, k, v, i_raw, f_raw):
    """One stabilised recurrence step, float32.  Shapes (B, H, dh) / (B, H)."""
    log_f = -softplus(-f_raw)                       # log σ(f̃)
    m_new = torch.maximum(log_f + state.m, i_raw)
    f_s = torch.exp(log_f + state.m - m_new)[..., None]
    i_s = torch.exp(i_raw - m_new)[..., None]
    C = state.C * f_s[..., None] + i_s[..., None] * (k[..., :, None]
                                                     * v[..., None, :])
    n = state.n * f_s + i_s * k
    num = torch.matmul(q[:, :, None, :], C)[:, :, 0]           # (B, H, dv)
    den = torch.maximum(torch.abs((q * n).sum(-1)),
                        torch.exp(-m_new))[..., None]
    return MLSTMState(C=C, n=n, m=m_new), num / den


def _init_mlstm_state(B, H, dh, device):
    f32 = torch.float32
    return MLSTMState(
        C=torch.zeros((B, H, dh, dh), dtype=f32, device=device),
        n=torch.zeros((B, H, dh), dtype=f32, device=device),
        m=torch.full((B, H), NEG_INIT, dtype=f32, device=device))


def _mlstm_out(params, h, z, *, site, quant, taps):
    dt = h.dtype
    h = layernorm(params["norm"], h)
    h = h * F.silu(z.to(torch.float32)).to(dt)
    return dense(params["down_proj"], h, site=f"{site}/down_proj",
                 quant=quant, taps=taps)


def mlstm_block_sequential(params, x, *, cfg, site,
                           quant: QuantContext = FP_CONTEXT,
                           taps: Optional[Taps] = None,
                           state: Optional[MLSTMState] = None,
                           return_state: bool = False
                           ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Position by position (the exact oracle of the chunked form)."""
    d_inner, H, dh = _dims(cfg)
    B, S, _ = x.shape
    f32 = torch.float32
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(params, x, site=site, quant=quant,
                                           taps=taps, cfg=cfg)
    s = state if state is not None else _init_mlstm_state(B, H, dh, x.device)
    hs = []
    for t in range(S):
        s, h = _mlstm_step(s, q[:, t].to(f32), k[:, t].to(f32),
                           v[:, t].to(f32), i_raw[:, t], f_raw[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d_inner).to(x.dtype)
    out = _mlstm_out(params, h, z, site=site, quant=quant, taps=taps)
    return out, (s if return_state else None)


def mlstm_block(params, x, *, cfg, site, quant: QuantContext = FP_CONTEXT,
                taps: Optional[Taps] = None,
                state: Optional[MLSTMState] = None,
                return_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Chunked-parallel mLSTM (exact, log-space stabilised), chunks of
    ``min(cfg.xlstm.chunk, S)``; a sequence is padded to a whole chunk with
    steps that forget nothing and add nothing.  Within a chunk the work is
    laid out (B, H, i, j)."""
    d_inner, H, dh = _dims(cfg)
    B, S, _ = x.shape
    f32 = torch.float32
    dev = x.device
    Lc = min(cfg.xlstm.chunk if cfg.xlstm else 256, S)
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(params, x, site=site, quant=quant,
                                           taps=taps, cfg=cfg)
    C_hat, n_hat, m = (state if state is not None
                       else _init_mlstm_state(B, H, dh, dev))

    pad = (-S) % Lc
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw, f_raw = (F.pad(t, (0, 0, 0, pad)) for t in (i_raw, f_raw))
    Sp = S + pad
    Nc = Sp // Lc
    heads = lambda t: t.to(f32).reshape(B, Nc, Lc, H, dh).permute(
        0, 1, 3, 2, 4)                                          # (B,Nc,H,Lc,dh)
    qc, kc, vc = heads(q), heads(k), heads(v)
    log_f = -softplus(-f_raw.reshape(B, Nc, Lc, H))
    log_i = i_raw.reshape(B, Nc, Lc, H)
    if pad:  # padded steps: forget = 1 (log 0), input = -inf
        valid = (torch.arange(Sp, device=dev) < S).reshape(Nc, Lc)[
            None, :, :, None]
        log_f = torch.where(valid, log_f, torch.zeros((), dtype=f32,
                                                      device=dev))
        log_i = torch.where(valid, log_i, torch.full((), NEG_INIT,
                                                     dtype=f32, device=dev))
    cum = torch.cumsum(log_f, dim=2).transpose(2, 3)            # (B,Nc,H,Lc)
    a = log_i.transpose(2, 3) - cum                             # log i_j - cum_j
    tril = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=f32, device=dev)

    hs = []
    for c in range(Nc):
        q_c, k_c, v_c = qc[:, c], kc[:, c], vc[:, c]            # (B,H,Lc,dh)
        cum_c, a_c = cum[:, c], a[:, c]                         # (B,H,Lc)
        # per-position stabiliser b_i = max(m, cummax_{j<=i} a_j)
        b = torch.maximum(m[..., None], torch.cummax(a_c, dim=-1).values)
        scores = torch.matmul(q_c, k_c.transpose(-1, -2))      # (B,H,i,j)
        W = torch.where(tril, torch.exp(a_c[:, :, None, :]
                                        - b[:, :, :, None]), zero)
        sw = scores * W
        inter = torch.exp(m[..., None] - b)                     # (B,H,i)
        num = torch.matmul(sw, v_c) + torch.matmul(q_c, C_hat) \
            * inter[..., None]
        den = sw.sum(-1) + torch.matmul(q_c, n_hat[..., None])[..., 0] \
            * inter
        m_i = cum_c + b                                         # full exponent
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_i))[..., None])

        # the chunk-end state
        b_L = torch.maximum(m, a_c.amax(dim=-1))                # (B,H)
        w_j = torch.exp(a_c - b_L[..., None])                   # (B,H,Lc)
        decay = torch.exp(m - b_L)
        kw = k_c * w_j[..., None]
        C_hat = C_hat * decay[..., None, None] + torch.matmul(
            kw.transpose(-1, -2), v_c)
        n_hat = n_hat * decay[..., None] + kw.sum(-2)
        m = cum_c[..., -1] + b_L
    h = torch.cat(hs, dim=2).transpose(1, 2)[:, :S]             # (B,S,H,dh)
    h = h.reshape(B, S, d_inner).to(x.dtype)
    out = _mlstm_out(params, h, z, site=site, quant=quant, taps=taps)
    final = MLSTMState(C=C_hat, n=n_hat, m=m) if return_state else None
    return out, final


def mlstm_decode_step(params, x, state: MLSTMState, *, cfg, site,
                      quant: QuantContext = FP_CONTEXT
                      ) -> Tuple[torch.Tensor, MLSTMState]:
    d_inner, H, dh = _dims(cfg)
    B = x.shape[0]
    f32 = torch.float32
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(params, x, site=site, quant=quant,
                                           taps=None, cfg=cfg)
    s2, h = _mlstm_step(state, q[:, 0].to(f32), k[:, 0].to(f32),
                        v[:, 0].to(f32), i_raw[:, 0], f_raw[:, 0])
    h = h.reshape(B, 1, d_inner).to(x.dtype)
    return _mlstm_out(params, h, z, site=site, quant=quant, taps=None), s2


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, *, dtype=torch.float32,
               device=None):
    d = cfg.d_model
    d_inner, H, dh = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": dense_init(gen, d, 4 * d_inner, bias=True, **kw),
        # recurrent weights, block-diagonal per head: (H, dh, 4*dh)
        "r_weight": torch.randn((H, dh, 4 * dh), generator=gen, **kw) * 0.05,
        "down_proj": dense_init(gen, d_inner, d, **kw),
        "norm": norm_init(d_inner, "layernorm", **kw),
    }


def _init_slstm_state(B, d_inner, device):
    z = torch.zeros((B, d_inner), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=torch.full_like(z, NEG_INIT))


def _slstm_step(s: SLSTMState, wx_t, r_w, H: int, dh: int) -> SLSTMState:
    """wx_t: (B, 4·d_inner) input contribution; r_w: (H, dh, 4·dh)."""
    B = wx_t.shape[0]
    rh = torch.matmul(s.h.reshape(B, H, dh).transpose(0, 1), r_w)
    raw = (wx_t + rh.transpose(0, 1).reshape(B, -1)).reshape(B, H, 4, dh)
    z_r, i_r, f_r, o_r = (raw[:, :, g].reshape(B, -1) for g in range(4))

    log_f = -softplus(-f_r)
    m_new = torch.maximum(log_f + s.m, i_r)
    f_s = torch.exp(log_f + s.m - m_new)
    i_s = torch.exp(i_r - m_new)
    c = f_s * s.c + i_s * torch.tanh(z_r)
    n = f_s * s.n + i_s
    h = torch.sigmoid(o_r) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_out(params, h, *, site, quant, taps):
    h = layernorm(params["norm"], h)
    return dense(params["down_proj"], h, site=f"{site}/down_proj",
                 quant=quant, taps=taps)


def slstm_block(params, x, *, cfg, site, quant: QuantContext = FP_CONTEXT,
                taps: Optional[Taps] = None,
                state: Optional[SLSTMState] = None,
                return_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    d_inner, H, dh = _dims(cfg)
    B, S, _ = x.shape
    wx = dense(params["in_proj"], x, site=f"{site}/in_proj", quant=quant,
               taps=taps).to(torch.float32)                # (B, S, 4·d_inner)
    s = state if state is not None else _init_slstm_state(B, d_inner,
                                                          x.device)
    r_w = params["r_weight"].to(torch.float32)
    hs = []
    for t in range(S):
        s = _slstm_step(s, wx[:, t], r_w, H, dh)
        hs.append(s.h)
    h = torch.stack(hs, dim=1).to(x.dtype)                  # (B, S, d_inner)
    out = _slstm_out(params, h, site=site, quant=quant, taps=taps)
    return out, (s if return_state else None)


def slstm_decode_step(params, x, state: SLSTMState, *, cfg, site,
                      quant: QuantContext = FP_CONTEXT
                      ) -> Tuple[torch.Tensor, SLSTMState]:
    d_inner, H, dh = _dims(cfg)
    B = x.shape[0]
    wx = dense(params["in_proj"], x, site=f"{site}/in_proj",
               quant=quant).to(torch.float32)[:, 0]
    s2 = _slstm_step(state, wx, params["r_weight"].to(torch.float32), H, dh)
    h = s2.h.reshape(B, 1, d_inner).to(x.dtype)
    return _slstm_out(params, h, site=site, quant=quant, taps=None), s2
