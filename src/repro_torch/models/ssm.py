"""Mamba2 (SSD) block — the zamba2 backbone.

Port of ``repro/models/ssm.py``.  The chunked state-space-dual algorithm:
within a chunk of ``cfg.ssm.chunk`` positions the output is an
attention-like product against a lower-triangular decay matrix; across
chunks a Python loop carries the (B, H, N, P) state.  A sequence is padded
to a whole chunk, as in the reference.  Decode is the O(1) recurrence.

The in/out projections are ``layers.dense`` sites (INT8 on K1/K2 + K3 when
quantized); the recurrence — exp, softplus, the divisions — stays float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.models.layers import dense, dense_init, rmsnorm


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, H, N, P) float32 — SSM state
    conv: torch.Tensor    # (B, W-1, d_inner) activation dtype — conv tail


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def ssm_init(gen: torch.Generator, cfg, *, dtype=torch.float32,
             device=None):
    s, d_inner, H = _dims(cfg)
    N = s.state
    kw = dict(dtype=dtype, device=device)
    # packed in-projection: [z (d_inner) | x (d_inner) | B (N) | C (N) | dt (H)]
    d_proj = 2 * d_inner + 2 * N + H
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_proj, **kw),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, **kw),
        "conv_w": torch.randn((s.conv_width, d_inner), generator=gen,
                              **kw) * 0.1,
        "conv_b": torch.zeros((d_inner,), **kw),
        "A_log": torch.zeros((H,), **kw),               # A = -exp(A_log)
        "D_skip": torch.ones((H,), **kw),
        "dt_bias": torch.zeros((H,), **kw),
        "norm": {"scale": torch.ones((d_inner,), **kw)},
    }


def _split_proj(proj, d_inner: int, N: int):
    z = proj[..., :d_inner]
    xs = proj[..., d_inner:2 * d_inner]
    Bm = proj[..., 2 * d_inner:2 * d_inner + N]
    Cm = proj[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xs, Bm, Cm, dt


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv along the sequence. x: (B, S, Dc); w: (W, Dc).
    The taps are summed in the reference's order, from 0."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return out + b, new_tail


def _gated_out(params, y, z, *, site, quant, taps, dt_):
    """Gated RMSNorm, then the out-projection."""
    y = y * F.silu(z.to(torch.float32))
    y = rmsnorm(params["norm"], y.to(dt_))
    return dense(params["out_proj"], y, site=f"{site}/out_proj", quant=quant,
                 taps=taps)


def ssm_block(
    params,
    x: torch.Tensor,                 # (B, S, D)
    *,
    cfg,
    site: str,
    quant: QuantContext = FP_CONTEXT,
    taps: Optional[Taps] = None,
    state: Optional[SSMState] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full-sequence (train/prefill) Mamba2 block, chunked SSD.

    The intra-chunk product ``y[i] = Σ_{j≤i} (C_i·B_j) e^{cum_i - cum_j}
    x̄_j`` is the scores times the decay, (B, H, Lc, Lc), then one batched
    matmul over ``j``."""
    s, d_inner, H = _dims(cfg)
    N, P, Lc = s.state, s.head_dim, s.chunk
    B, S, _ = x.shape
    dt_ = x.dtype
    f32 = torch.float32

    proj = dense(params["in_proj"], x, site=f"{site}/in_proj", quant=quant,
                 taps=taps)
    z, xs, Bm, Cm, dt = _split_proj(proj, d_inner, N)

    conv_tail = state.conv if state is not None else None
    xs, new_tail = _causal_conv(xs, params["conv_w"].to(dt_),
                                params["conv_b"].to(dt_), conv_tail)
    xs = F.silu(xs.to(f32))

    xh = xs.reshape(B, S, H, P)
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))      # (B, S, H)
    A = -torch.exp(params["A_log"].to(f32))                     # (H,)
    Bf = Bm.to(f32)                                             # (B, S, N)
    Cf = Cm.to(f32)

    pad = (-S) % Lc
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    Sp = S + pad
    Nc = Sp // Lc
    xc = xh.reshape(B, Nc, Lc, H, P)
    dtc = dt.reshape(B, Nc, Lc, H)
    Bc = Bf.reshape(B, Nc, Lc, N)
    Cc = Cf.reshape(B, Nc, Lc, N)
    cum = torch.cumsum(dtc * A, dim=2)                          # within-chunk

    h = (state.h if state is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x.device))
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c in range(Nc):
        x_c, dt_c, B_c, C_c = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum_h = cum[:, c].transpose(1, 2)                       # (B, H, Lc)
        xbar = (x_c * dt_c[..., None]).transpose(1, 2)          # (B, H, Lc, P)
        # intra-chunk: scores (B, i, j) times the decay (B, H, i, j)
        decay = torch.exp(cum_h[:, :, :, None] - cum_h[:, :, None, :])
        decay = torch.where(tri, decay, torch.zeros((), dtype=f32,
                                                    device=x.device))
        scores = torch.matmul(C_c, B_c.transpose(1, 2))        # (B, i, j)
        y = torch.matmul(scores[:, None] * decay, xbar)         # (B, H, i, P)
        # inter-chunk: y[i] += C_i · h_prev · e^{cum_i}
        y = y + torch.matmul(C_c[:, None], h) * torch.exp(cum_h)[..., None]
        # state: h = h·e^{cum_last} + Σ_j e^{cum_last - cum_j} B_j x̄_jᵀ
        last = cum_h[:, :, -1]                                  # (B, H)
        wx = xbar * torch.exp(last[:, :, None] - cum_h)[..., None]
        h = h * torch.exp(last)[:, :, None, None] + torch.matmul(
            B_c.transpose(1, 2)[:, None], wx)                   # (B, H, N, P)
        ys.append(y.transpose(1, 2))                            # (B, Lc, H, P)
    y = torch.cat(ys, dim=1)[:, :S]

    y = y + params["D_skip"].to(f32)[None, None, :, None] * xh[:, :S]
    y = y.reshape(B, S, d_inner)
    out = _gated_out(params, y, z, site=site, quant=quant, taps=taps,
                     dt_=dt_)
    new_state = SSMState(h=h, conv=new_tail) if return_state else None
    return out, new_state


def ssm_decode_step(
    params,
    x: torch.Tensor,                 # (B, 1, D)
    state: SSMState,
    *,
    cfg,
    site: str,
    quant: QuantContext = FP_CONTEXT,
) -> Tuple[torch.Tensor, SSMState]:
    """O(1) single-token recurrence: h = h·exp(A·dt) + B x̄ᵀ ; y = C·h."""
    s, d_inner, H = _dims(cfg)
    N, P = s.state, s.head_dim
    B = x.shape[0]
    dt_ = x.dtype
    f32 = torch.float32

    proj = dense(params["in_proj"], x, site=f"{site}/in_proj", quant=quant)
    z, xs, Bm, Cm, dt = _split_proj(proj, d_inner, N)

    xs, new_tail = _causal_conv(xs, params["conv_w"].to(dt_),
                                params["conv_b"].to(dt_), state.conv)
    xs = F.silu(xs.to(f32))

    xh = xs.reshape(B, H, P)
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))[:, 0]   # (B, H)
    A = -torch.exp(params["A_log"].to(f32))
    decay = torch.exp(dt * A)                                      # (B, H)
    xbar = xh * dt[..., None]                                      # (B, H, P)
    Bf = Bm.to(f32)[:, 0]                                          # (B, N)
    Cf = Cm.to(f32)[:, 0]

    h = state.h * decay[:, :, None, None] + (
        Bf[:, None, :, None] * xbar[:, :, None, :])
    y = torch.matmul(Cf[:, None, None, :], h)[:, :, 0]             # (B, H, P)
    y = y + params["D_skip"].to(f32)[None, :, None] * xh
    y = y.reshape(B, 1, d_inner)
    out = _gated_out(params, y, z, site=site, quant=quant, taps=None,
                     dt_=dt_)
    return out, SSMState(h=h, conv=new_tail)
