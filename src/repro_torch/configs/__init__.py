"""Architecture registry: ``get_config("transformer-base")``,
``get_config("granite-moe-1b-a400m")``."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    get_config,
    register,
)
from repro_torch.configs import granite_moe_1b_a400m  # noqa: F401
from repro_torch.configs import transformer_base  # noqa: F401
