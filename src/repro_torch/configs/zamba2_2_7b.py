"""zamba2-2.7b — 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

Hybrid family → runs the ``long_500k`` cell (SSM state is O(1) in sequence;
only the shared-attention KV cache scales with context).  ``build_model``
gives ``models.hybrid.HybridLM``.
"""

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        ffn="gelu",
        ssm=SSMConfig(state=64, head_dim=64, expand=2),
        hybrid=HybridConfig(attn_every=6),
    )
