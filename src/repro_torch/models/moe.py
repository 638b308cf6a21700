"""Mixture-of-Experts FFN with GShard-style grouped dispatch.

Port of ``repro/models/moe.py``.  Tokens are split into fixed groups of
``group_size``; capacity is per group (``C = max(ceil(group_size · top_k /
E · capacity_factor), 4)``), so every expert takes ``G · C`` rows whatever
the routing.  The reference dispatches and combines with one-hot einsums;
here they are index scatters and gathers over the same positions, which give
every expert row bit for bit (empty slots zero) and the same combine
weights.  The expert FFNs are grouped matmuls: per-expert batched
s8·s8→s32 through ``kernels.ops.int8_matmul_batched`` (K7) when quantized.
Tensor parallel (``experts["tp"]``, ``distributed.collectives``): every
rank routes over all the experts and runs K7 over its own.  On a training
mesh each data rank routes its rows of the global batch, which must hold
whole routing groups of the reference's cut, and the load-balance loss and
the dropped fraction are taken over the global batch.

The router linear is deny-listed from quantization by default
(``core.policy.DEFAULT_DENY``): its logits feed a softmax/top-k, the class of
op the paper keeps in FP32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.calibration import Taps, record
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.core.qtensor import QTensor
from repro_torch.distributed.collectives import data_sum, tp_gather, tp_split
from repro_torch.distributed.context import data_group
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    block_input,
    block_output,
    dense,
    dense_init,
    top_k,
)

# a static site's weight scales times its activation scale, kept per
# weight-scale tensor (by identity) and activation scale: the product
# depends only on the weights and the calibration, so a decode step does
# not recompute it
_folded_scales = WeakIdKeyDictionary()


def _folded_scale(w: QTensor, scale: float) -> torch.Tensor:
    per_w = _folded_scales.setdefault(w.scale, {})
    if scale not in per_w:
        E, _, N = w.data.shape
        per_w[scale] = w.scale.reshape(E, 1, N) * scale
    return per_w[scale]


def moe_init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    d, f, m = cfg.d_model, cfg.d_ff, cfg.moe
    kw = dict(dtype=dtype, device=device)
    experts = dict(kw, stack=(m.n_experts,))
    return {
        "router": dense_init(gen, d, m.n_experts, **kw),
        "experts": {
            "gate": dense_init(gen, d, f, **experts),
            "up": dense_init(gen, d, f, **experts),
            "down": dense_init(gen, f, d, **experts),
        },
    }


def _expert_dense(node, x: torch.Tensor, *, site: str, quant: QuantContext,
                  taps: Optional[Taps]) -> torch.Tensor:
    """Batched per-expert linear: x (E, M, K) @ w (E, K, N).

    The activations are quantized by K1/K2 over the E·M rows
    (``ops.quantize_static`` / ``ops.quantize_rowwise``), in the form the
    reference's jitted programs compute (``moe.py:57-71`` under XLA's
    rewrite of a division by a constant):

    * static: ``scale = float32(t_max) / 127`` (folded exactly), the
      codes ``round(x · float32(1 / scale))`` (K1's function with the
      threshold unclamped: the reference does not clamp it at 1e-12), and
      the epilogue ``acc · (scale · b_scale)``: XLA multiplies the
      constant into the weight scales first, so K7 gets the activation
      scale 1 and those products as its weight scales;
    * dynamic: ``scale = amax · float32(1/127)`` per (expert, row), the
      codes ``round(x / scale)`` (an IEEE division by a tensor; K2's
      function), and the epilogue ``acc · scale · b_scale``.
    """
    w = node["w"]
    record(taps, site, x)
    if isinstance(w, QTensor):
        E, _, N = w.data.shape
        thr = quant.activation_thresholds(site)
        if thr is not None and thr.symmetric:
            scale = np.float32(thr.t_max) / np.float32(127.0)
            q = ops.quantize_static(x, thr.t_max, impl=quant.impl,
                                    clamp=False).data
            xq = QTensor(q, 1.0, 0.0, None)
            b_scale = _folded_scale(w, float(scale))
        else:
            xq = ops.quantize_rowwise(x, impl=quant.impl)
            b_scale = w.scale.reshape(E, 1, N)
        wq = QTensor(w.data, b_scale, 0.0, None)
        return ops.int8_matmul_batched(xq, wq, out_dtype=x.dtype,
                                       impl=quant.impl)
    return torch.bmm(x, w.to(x.dtype))


def _route(logits: torch.Tensor, k: int, capacity: int):
    """Top-``k`` routing of (G, Sg, E) router logits with a per-group
    capacity.  Returns ``(probs, gate_vals, expert_idx, pos, keep)``:
    ``gate_vals`` renormalized over the chosen experts, ``pos`` each
    (token, choice) pair's place in its expert's queue (a cumsum in
    token-major order, ``repro/models/moe.py:115-118``), ``keep = pos <
    capacity``."""
    G, g_sz, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                  # (G, Sg, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    # one-hot by comparison: F.one_hot reads the indices' range on the host
    experts = torch.arange(E, device=logits.device)
    onehot_e = (expert_idx[..., None] == experts).to(torch.int32)  # (G,Sg,k,E)
    flat = onehot_e.reshape(G, g_sz * k, E)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).reshape(
        G, g_sz, k, E)
    pos = torch.gather(pos, -1, expert_idx[..., None])[..., 0]
    return probs, gate_vals, expert_idx, pos, pos < capacity


def moe_ffn(
    params,
    x: torch.Tensor,                 # (B, S, D)
    *,
    cfg,
    site: str,
    quant: QuantContext = FP_CONTEXT,
    taps: Optional[Taps] = None,
):
    """Returns (output (B, S, D), aux) where aux carries load-balance stats.

    Every (token, choice) pair takes the next free slot of its expert's
    queue in its group, in token-major order; a pair at or past the
    capacity is dropped and contributes zero.  The padding rows of the last
    group (exact zeros) route like any token: their router logits are all
    zero, the softmax uniform, and ``top_k`` breaks the ties toward the
    lower expert index, as ``jax.lax.top_k`` does.

    On a training mesh (``distributed.context.data_group``) the reference
    cuts the global batch's tokens into its groups, so this rank's rows
    must be whole groups of that cut (else a ``ValueError``); the
    load-balance loss is this rank's share of the global one (its sum
    over the data group), from expert statistics SUMmed over the group.
    """
    x = block_input(x, params["experts"])
    B, S, D = x.shape
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    dt = x.dtype
    data = data_group()
    n_data = 1 if data is None else data.size

    tokens = B * S
    g_sz = min(m.group_size, tokens * n_data)
    if tokens % g_sz and n_data > 1:
        raise ValueError(
            f"{site}: a data rank's {B} rows × {S} positions = {tokens} "
            f"tokens are not whole routing groups of {g_sz} of the global "
            f"batch's {tokens * n_data} tokens (rows a rank × sequence "
            "length must divide by the group size)")
    pad = (-tokens) % g_sz
    x_flat = x.reshape(tokens, D)
    if pad:
        x_flat = F.pad(x_flat, (0, 0, 0, pad))
    G = (tokens + pad) // g_sz
    xg = x_flat.reshape(G, g_sz, D)

    # ---- routing (kept fp32: softmax/top-k — paper §3 rule) ----
    logits = dense(params["router"], xg, site=f"{site}/router", quant=quant,
                   taps=taps).to(torch.float32)               # (G, Sg, E)
    capacity = max(int(math.ceil(g_sz * K / E * m.capacity_factor)), 4)
    probs, gate_vals, expert_idx, pos, keep = _route(logits, K, capacity)

    # ---- dispatch → expert FFN (grouped) → combine ----
    # each kept pair owns row e·G·C + g·C + pos of the (E·G·C, D) expert
    # input; dropped pairs go to one spare row past the end
    n_rows = E * G * capacity
    group = torch.arange(G, device=x.device)[:, None, None]
    slot = torch.where(keep, expert_idx * (G * capacity) + group * capacity
                       + pos, n_rows).reshape(-1)
    xe = x.new_zeros((n_rows + 1, D))
    xe[slot] = xg[:, :, None, :].expand(G, g_sz, K, D).reshape(-1, D)
    xe = xe[:n_rows].view(E, G * capacity, D)
    experts = params["experts"]
    par = experts.get("tp")
    if par is not None:
        # expert parallel: this rank runs its E/tp experts on their rows
        # (their codes and K7's s32 sums are the unsharded ones) and
        # gathers every expert's output, E·G·C·D elements a layer; the
        # combine below then sums in the unsharded order
        xe = tp_split(xe, 0, par.group)
    g = _expert_dense(experts["gate"], xe, site=f"{site}/experts/gate",
                      quant=quant, taps=taps)
    u = _expert_dense(experts["up"], xe, site=f"{site}/experts/up",
                      quant=quant, taps=taps)
    h = F.silu(g.to(torch.float32)).to(dt) * u
    y_e = _expert_dense(experts["down"], h, site=f"{site}/experts/down",
                        quant=quant, taps=taps)
    if par is not None:
        y_e = tp_gather(y_e, 0, par.group)
    # combine: each token sums its kept choices' expert rows weighted by
    # their gate values (in the activation dtype, as the reference's combine
    # tensor holds them); a dropped pair reads the zero row past the end
    y_rows = torch.cat([y_e.reshape(n_rows, D), y_e.new_zeros((1, D))])
    picked = y_rows[slot].reshape(G, g_sz, K, D).to(torch.float32)
    weights = gate_vals.to(dt).to(torch.float32)
    y = (picked * weights[..., None]).sum(dim=2).to(dt)      # (G, Sg, D)

    y = y.reshape(-1, D)
    if pad:
        y = y[:tokens]
    y = y.reshape(B, S, D)

    # load-balance aux loss terms (Switch-style)
    first = expert_idx[..., 0].reshape(-1, 1)
    chosen = (first == torch.arange(E, device=x.device)).to(torch.float32)
    if n_data == 1:
        me = probs.reshape(-1, E).mean(dim=0)
        lb = E * torch.sum(me * chosen.mean(dim=0))
        kept = keep.to(torch.float32).mean()
    else:
        # E·Σ me·ce is not linear in a rank's tokens: the statistics are
        # summed over the data group first, and each rank's loss takes
        # 1/n_data of the product (so the gradient SUMs over the group)
        n = probs.shape[0] * probs.shape[1] * n_data
        me = data_sum(probs.reshape(-1, E).sum(dim=0), data) / n
        ce = data.all_reduce(chosen.sum(dim=0)) / n
        lb = E * torch.sum(me * ce) / n_data
        kept = data.all_reduce(keep.to(torch.float32).sum()) / (
            keep.numel() * n_data)
    aux = {"load_balance_loss": lb, "dropped_fraction": 1.0 - kept}
    return block_output(y), aux
