"""The port's models (port of ``repro/models``): the encoder-decoder
translation model and the decoder-only (MoE) language model."""

from repro_torch.models import kv_cache  # noqa: F401
from repro_torch.models.encdec import EncDecLM  # noqa: F401
from repro_torch.models.registry import build_model  # noqa: F401
from repro_torch.models.transformer import DecoderLM  # noqa: F401
