"""command-r-35b — 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]
"""

from repro_torch.configs.base import ModelConfig, register


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab=256000,
        norm="layernorm",
        attn_bias=False,
        tie_embeddings=True,
        rope_theta=8_000_000.0,
    )
