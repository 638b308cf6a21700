"""GELU feed-forward block of the enc-dec family (port of
``repro/models/ffn.py``; the SwiGLU branch of the dense decoder-only
family is not ported yet, ROADMAP Queue 1: the rest of the model zoo).

Both matmuls route through :func:`repro_torch.models.layers.dense`, so the
FFN picks up the INT8 path when its weights are quantized.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.models.layers import dense, dense_init


def ffn_init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    if cfg.ffn != "gelu":
        raise NotImplementedError(f"the port has the GELU FFN only, not "
                                  f"{cfg.ffn!r} (ROADMAP Queue 1: the rest "
                                  "of the model zoo)")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "in": dense_init(gen, d, f, bias=cfg.attn_bias, dtype=dtype,
                         device=device),
        "out": dense_init(gen, f, d, bias=cfg.attn_bias, dtype=dtype,
                          device=device),
    }


def ffn(params, x: torch.Tensor, *, cfg, site: str,
        quant: QuantContext = FP_CONTEXT,
        taps: Optional[Taps] = None) -> torch.Tensor:
    if cfg.ffn != "gelu":
        raise NotImplementedError(f"the port has the GELU FFN only, "
                                  f"not {cfg.ffn!r}")
    h = dense(params["in"], x, site=f"{site}/in", quant=quant, taps=taps)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(params["out"], h, site=f"{site}/out", quant=quant, taps=taps)
