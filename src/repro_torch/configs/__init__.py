"""Architecture registry: one module per assigned arch (and the paper's own).

``get_config("<arch-id>")`` returns the published configuration;
``cfg.reduced()`` the same-family smoke-test configuration.
"""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    QuantSettings,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    list_archs,
    register,
    shapes_for,
)

# Import every arch module so @register runs.
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    granite_8b,
    granite_moe_1b_a400m,
    internvl2_76b,
    mistral_nemo_12b,
    qwen3_moe_30b_a3b,
    transformer_base,
    whisper_base,
    xlstm_1_3b,
    yi_9b,
    zamba2_2_7b,
)
