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
from repro_torch.models.transformer import DecoderLM

_FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "audio": EncDecLM,
}
# the reference's other families, still to port
_NOT_PORTED = ("hybrid", "ssm")


def build_model(cfg, *, device: str = "cuda"):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP Queue 1: "
            "the rest of the model zoo)")
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family}")
    return _FAMILIES[cfg.family](cfg, device=device)
