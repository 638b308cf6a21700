"""Shared model layers.  ``dense`` is the quantization integration point.

Port of ``repro/models/layers.py`` (the INT8 and INT4-weight paths,
layernorm, RMSNorm and rotary embeddings).  Conventions are the
reference's:

* every linear is a dict node ``{"w": (d_in, d_out)[, "b": (d_out,)]}``;
* quantized weights are :class:`QTensor` with keepdims per-output-channel
  scales ``(1, d_out)``, or block-wise INT4 :class:`BlockQTensor`;
* each linear has a *site* name (its parameter path); calibration taps
  record the matmul input under that name and the QuantContext resolves
  activation thresholds and policy by it.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.calibration import Taps, record
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.core.qtensor import BlockQTensor, QTensor
from repro_torch.core.quantize import quantize_with_thresholds
from repro_torch.distributed.collectives import (
    fsdp_gather,
    tp_enter,
    tp_gather,
    tp_row_sum,
    tp_split,
)
from repro_torch.distributed.context import constrain_logits, sequence_group
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# init helpers (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32, device=None,
               stack: tuple = ()) -> Dict[str, Any]:
    """Uniform ±1/√d_in weights (``stack``: leading expert dims)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.rand((*stack, d_in, d_out), generator=gen, dtype=dtype,
                   device=device)
    node = {"w": w * (2 * scale) - scale}
    if bias:
        node["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return node


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device=None) -> Dict[str, Any]:
    return {"table": torch.randn((vocab, d_model), generator=gen, dtype=dtype,
                                 device=device) * 0.02}


def norm_init(d: int, kind: str, *, dtype=torch.float32, device=None):
    node = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        node["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return node


# ---------------------------------------------------------------------------
# forward ops
# ---------------------------------------------------------------------------

def dense(
    node: Dict[str, Any],
    x: torch.Tensor,
    *,
    site: str,
    quant: QuantContext = FP_CONTEXT,
    taps: Optional[Taps] = None,
) -> torch.Tensor:
    """Linear layer: a float matmul, or the paper's INT8 path when ``w`` is a
    QTensor or a BlockQTensor.

    INT8 path: the activation is quantized with the calibrated static
    threshold (K1) or dynamically per row (K2), then the matmul runs
    s8·s8→s32 with the dequantize epilogue fused (K3).  A BlockQTensor
    weight keeps the INT8 activation and runs the INT4-weight matmul with
    the nibbles dequantized in the kernel (K6).
    """
    par = node.get("tp")
    if par is not None:
        return _dense_parallel(node, x, par, site=site, quant=quant,
                               taps=taps)
    w = node["w"]
    b = node.get("b")
    record(taps, site, x)

    if isinstance(w, (QTensor, BlockQTensor)):
        thr = quant.activation_thresholds(site)
        if thr is None:
            xq = ops.quantize_rowwise(x, impl=quant.impl)
        elif thr.symmetric:
            xq = ops.quantize_static(x, thr.t_max, impl=quant.impl)
        else:
            # independent mode: affine activation quantization; the
            # zero-point correction folds into the matmul epilogue
            xq = quantize_with_thresholds(x, thr)
        bias = None if b is None else b.to(torch.float32)
        if isinstance(w, BlockQTensor):
            return ops.int4_matmul(xq, w, bias, out_dtype=x.dtype,
                                   impl=quant.impl)
        N = w.data.shape[-1]
        w2 = QTensor(w.data, w.scale.reshape(1, N), 0.0, None)
        return ops.int8_matmul(xq, w2, bias, out_dtype=x.dtype,
                               impl=quant.impl)

    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _dense_parallel(node, x: torch.Tensor, par, *, site: str,
                    quant: QuantContext, taps: Optional[Taps]
                    ) -> torch.Tensor:
    """The tensor-parallel forms of :func:`dense` (``node["tp"]``, from
    ``distributed.collectives.mark_parallel``).

    ``"gather"``: a replicated weight behind a split producer (an INT4
    out-projection): gather the input's features, then the plain dense.

    ``"row"``: the weight's input features are split and ``x`` holds this
    rank's.  INT8: the codes' s32 accumulators are summed over the ranks
    and the epilogue runs once, which is what a partitioned s8·s8→s32 dot
    computes, so the result is the unsharded one bit for bit.  Dynamic
    scales (K2) quantize the gathered whole row and keep this rank's
    codes; a static threshold (K1) is a scalar and needs nothing; the zero
    point's column sums are summed over the ranks too.  Float: the partial
    products are summed in float32 and cast once; the bias is added after
    the sum.
    """
    g = par.group
    rest = {k: v for k, v in node.items() if k != "tp"}
    if par.kind == "gather":
        return dense(rest, g.all_gather(x, -1), site=site, quant=quant,
                     taps=taps)
    if par.kind != "row":
        raise ValueError(f"{site}: a linear has no {par.kind!r} form")
    w, b = node["w"], node.get("b")
    record(taps, site, x)
    if isinstance(w, BlockQTensor):
        raise ValueError(f"{site}: INT4 weights never split their rows")
    if isinstance(w, QTensor):
        thr = quant.activation_thresholds(site)
        if thr is None:
            full = ops.quantize_rowwise(g.all_gather(x, -1), impl=quant.impl)
            k = x.shape[-1]
            xq = QTensor(full.data[..., g.rank * k:(g.rank + 1) * k]
                         .contiguous(), full.scale, 0.0, None)
        elif thr.symmetric:
            xq = ops.quantize_static(x, thr.t_max, impl=quant.impl)
        else:
            xq = quantize_with_thresholds(x, thr)
        acc = g.all_reduce(ops.int8_matmul_accumulate(xq.data, w.data,
                                                      impl=quant.impl))
        colsum = None
        if not (isinstance(xq.zero_point, float) and xq.zero_point == 0.0):
            colsum = g.all_reduce(w.data.to(torch.int32).sum(dim=0))
        N = w.data.shape[-1]
        return ops.int8_matmul_epilogue(
            acc, xq.scale, w.scale.reshape(1, N), xq.zero_point, colsum,
            None if b is None else b.to(torch.float32), out_dtype=x.dtype,
            impl=quant.impl)
    part = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    y = tp_row_sum(part, g).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` semantics: the k largest along the last axis,
    descending, ties broken toward the lower index.  ``torch.topk`` promises
    no tie order on CUDA, so this is a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def embed(node, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table, cast to ``dtype`` (gather, then cast: the same
    values as casting the table first).  Vocab-parallel (``node["tp"]``):
    each rank looks up the ids in its rows, zeros elsewhere, and the ranks'
    rows are summed, which is exact."""
    table = node["table"]
    par = node.get("tp")
    if par is None:
        return table[ids].to(dtype)
    v = table.shape[0]
    local = ids.long() - par.group.rank * v
    mine = (local >= 0) & (local < v)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return tp_row_sum(rows, par.group).to(dtype)


def unembed(node, x: torch.Tensor):
    """Logits head via the tied embedding transpose, in float32.
    Vocab-parallel: this rank's logits, gathered over the vocabulary, or,
    under a training mesh's activation sharding, kept split as a
    ``distributed.context.VocabShard`` for the loss
    (``context.constrain_logits``)."""
    x = block_input(x, node)
    logits = torch.matmul(x.to(torch.float32),
                          node["table"].to(torch.float32).t())
    par = node.get("tp")
    return logits if par is None else constrain_logits(logits, par.group)


def block_input(x: torch.Tensor, node, *, whole: bool = False
                ) -> torch.Tensor:
    """``x`` as it enters a tensor-parallel block's column-split
    projections: where ``node`` (the block's out-projection, or the tied
    table for the unembed) carries a ``"row"`` or ``"vocab"`` mark, each
    rank's input gradient is a partial sum, so under autograd ``x``'s
    gradient is SUMmed over the group (``collectives.tp_enter``).
    Otherwise ``x`` as it is.

    Inside a block on a sequence-split residual
    (``distributed.context.sequence_group``), ``x`` is this rank's rows
    (``whole``: an input every rank holds whole, the encoder memory): they
    are gathered on the sequence, the gradient SUMmed over the group and
    cut back where the projections are split
    (``collectives.fsdp_gather``), cut back alone where the sub-layer runs
    whole on every rank (``collectives.tp_gather``: an MoE FFN, a
    projection whose width does not divide the group)."""
    par = node.get("tp") if isinstance(node, dict) else None
    split = par is not None and par.kind in ("row", "vocab")
    rows = None if whole else sequence_group()
    if rows is not None:
        return fsdp_gather(x, 1, rows) if split else tp_gather(x, 1, rows)
    return tp_enter(x, par.group) if split else x


def block_output(y: torch.Tensor) -> torch.Tensor:
    """A sub-layer's whole output (the same on every rank of the tensor
    axis) cut back to this rank's rows on a sequence-split residual, its
    gradient gathered (``collectives.tp_split``); else ``y``.  A
    row-parallel projection's bias is added before the cut, so its
    gradient sums the whole sequence."""
    rows = sequence_group()
    return y if rows is None else tp_split(y, 1, rows)


def layernorm(node, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 layernorm with the biased variance, as the reference."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * node["scale"].to(torch.float32)
    if "bias" in node:
        y = y + node["bias"].to(torch.float32)
    return y.to(x.dtype)


def rmsnorm(node, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * node["scale"].to(torch.float32)).to(x.dtype)


def norm(node, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Layernorm or RMSNorm.  On this rank's rows of a sequence-split
    residual (``distributed.context.sequence_group``) the parameters'
    gradients are partial sums over the rows, SUMmed over the group
    (``collectives.tp_enter``)."""
    rows = sequence_group()
    if rows is not None:
        node = {k: tp_enter(v, rows) for k, v in node.items()}
    return layernorm(node, x) if kind == "layernorm" else rmsnorm(node, x)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _rope_frequencies_on(head_dim: int, theta: float,
                         device: str) -> torch.Tensor:
    exps = (torch.arange(0, head_dim, 2, dtype=torch.float32)
            / head_dim).to(torch.float64)
    return (1.0 / theta ** exps).to(device=device, dtype=torch.float32)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)`` as float32, computed in float64 on the
    host and rounded once (then kept on ``device``).  Inside the
    reference's jitted programs XLA folds these constants to the correctly
    rounded values; torch's (and eager JAX's) float32 ``pow`` differs from
    them in the last bit on about a third of the entries."""
    return _rope_frequencies_on(head_dim, float(theta),
                                str(torch.device(device or "cpu")))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int32.  Rotates the two halves
    of the head dimension (not interleaved pairs), in float32.

    The angles are the reference's float32 products; their cosine and sine
    are taken in float64 and rounded once, which agrees with XLA's float32
    ``cos``/``sin`` on about 99% of entries (torch's float32 ones on 95%)
    and is within one float32 ulp elsewhere.
    """
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)
    angles = (positions[..., None].to(torch.float32)
              * freqs).to(torch.float64)                    # (B, S, dh/2)
    cos = torch.cos(angles).to(torch.float32)[:, :, None, :]
    sin = torch.sin(angles).to(torch.float32)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
