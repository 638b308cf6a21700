"""internvl2-76b — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT + InternLM2 backbone. [arXiv:2404.16821]

VLM entry: this config specifies the transformer BACKBONE only; the vision
frontend is a stub — the batch's ``embeds`` carries precomputed patch
embeddings (B, S, d_model), so ``input_kind="embeddings"``.
"""

from repro_torch.configs.base import ModelConfig, register


@register("internvl2-76b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        input_kind="embeddings",
    )
