"""Feed-forward blocks: SwiGLU (the llama family) and the GELU MLP (the
enc-dec family).  Port of ``repro/models/ffn.py``.

Every matmul routes through :func:`repro_torch.models.layers.dense`, so
every FFN of the zoo picks up the INT8 path when its weights are quantized
(sites ``…/ffn/gate|up|down`` or ``…/ffn/in|out``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.calibration import Taps
from repro_torch.core.ptq import FP_CONTEXT, QuantContext
from repro_torch.models.layers import (
    block_input,
    block_output,
    dense,
    dense_init,
)


def ffn_init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    if cfg.ffn == "swiglu":
        return {
            "gate": dense_init(gen, d, f, **kw),
            "up": dense_init(gen, d, f, **kw),
            "down": dense_init(gen, f, d, **kw),
        }
    return {
        "in": dense_init(gen, d, f, bias=cfg.attn_bias, **kw),
        "out": dense_init(gen, f, d, bias=cfg.attn_bias, **kw),
    }


def ffn(params, x: torch.Tensor, *, cfg, site: str,
        quant: QuantContext = FP_CONTEXT,
        taps: Optional[Taps] = None) -> torch.Tensor:
    x = block_input(x, params["down" if cfg.ffn == "swiglu" else "out"])
    if cfg.ffn == "swiglu":
        g = dense(params["gate"], x, site=f"{site}/gate", quant=quant,
                  taps=taps)
        u = dense(params["up"], x, site=f"{site}/up", quant=quant, taps=taps)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        return block_output(dense(params["down"], h, site=f"{site}/down",
                                  quant=quant, taps=taps))
    h = dense(params["in"], x, site=f"{site}/in", quant=quant, taps=taps)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return block_output(dense(params["out"], h, site=f"{site}/out",
                              quant=quant, taps=taps))
