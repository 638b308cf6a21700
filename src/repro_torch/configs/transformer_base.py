"""transformer-base — the paper's own model (Vaswani et al. 2017, base).

6L encoder + 6L decoder, d_model=512, 8 heads, d_ff=2048, shared vocab
37000 (the paper's En→De WMT model).
"""

from repro_torch.configs.base import ModelConfig, register


@register("transformer-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="transformer-base",
        family="audio",          # the reference's enc-dec model family
        n_layers=6,
        n_enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=37000,
        norm="layernorm",
        ffn="gelu",
        enc_dec=True,
        attn_bias=True,
        input_kind="tokens",
        tie_embeddings=True,
    )
