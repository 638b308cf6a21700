"""Model registry: ``ModelConfig.family`` → model class (port of
``repro/models/registry.py``).

Every model exposes the reference's protocol, on a ``device``:

    model = build_model(cfg, device="cuda")
    params           = model.init(generator)
    logits, aux      = model.forward(params, batch, quant=..., taps=...)
    state            = model.init_decode_state(B, max_len, quantized=...)
    logits, state    = model.prefill(params, batch, state, quant=...)
    logits, state    = model.decode_step(params, tokens, state, quant=...)
"""

from __future__ import annotations

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.xlstm_model import XLSTMLM

_FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "audio": EncDecLM,
    "hybrid": HybridLM,
    "ssm": XLSTMLM,
}


def build_model(cfg, *, device: str = "cuda"):
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family}")
    return _FAMILIES[cfg.family](cfg, device=device)
