"""whisper-base — 6L d_model=512 8H d_ff=2048 vocab=51865, enc-dec.
[arXiv:2212.04356]

Audio entry: the conv frontend is a STUB — the batch's ``src_embeds``
carries precomputed frame embeddings (B, S_enc, d_model) for the encoder;
the decoder consumes tokens.
"""

from repro_torch.configs.base import ModelConfig, register


@register("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,              # decoder layers
        n_enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        norm="layernorm",
        ffn="gelu",
        enc_dec=True,
        attn_bias=True,
        input_kind="embeddings",
    )
