"""xlstm-1.3b — 48L d_model=2048 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks (the block's own up/down projections replace the FFN,
hence d_ff=0). [arXiv:2405.04517]

SSM family → runs the ``long_500k`` cell (recurrent state is O(1) in
sequence length).  ``build_model`` gives ``models.xlstm_model.XLSTMLM``.
"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig, register


@register("xlstm-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        ffn="none",
        norm="layernorm",
        xlstm=XLSTMConfig(slstm_every=8),
    )
