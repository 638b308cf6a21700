"""Shared model layers.  ``dense`` is the quantization integration point.

Port of ``repro/models/layers.py`` (the INT8 and INT4-weight paths and
layernorm; RMSNorm and rotary embeddings are not ported yet).  Conventions
are the reference's:

* every linear is a dict node ``{"w": (d_in, d_out)[, "b": (d_out,)]}``;
* quantized weights are :class:`QTensor` with keepdims per-output-channel
  scales ``(1, d_out)``, or block-wise INT4 :class:`BlockQTensor`;
* each linear has a *site* name (its parameter path); calibration taps
  record the matmul input under that name and the QuantContext resolves
  activation thresholds and policy by it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.calibration import Taps, record
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.core.qtensor import BlockQTensor, QTensor
from repro_torch.core.quantize import quantize_with_thresholds
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# init helpers (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               device=None) -> Dict[str, Any]:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.rand((d_in, d_out), generator=gen, dtype=dtype, device=device)
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


def embed(node, ids: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    return node["table"][ids].to(dtype)


def unembed(node, x: torch.Tensor) -> torch.Tensor:
    """Logits head via the tied embedding transpose, in float32."""
    return torch.matmul(x.to(torch.float32),
                        node["table"].to(torch.float32).t())


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


def norm(node, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "layernorm":
        raise NotImplementedError(f"the port has layernorm only, not {kind!r}")
    return layernorm(node, x)
