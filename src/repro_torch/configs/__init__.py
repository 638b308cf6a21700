"""Architecture registry: ``get_config("transformer-base")``."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    register,
)
from repro_torch.configs import transformer_base  # noqa: F401
