"""The port's models (port of ``repro/models``): the encoder-decoder
translation model, the decoder-only (dense, MoE, VLM) language model, the
Mamba2 + shared-attention hybrid and the xLSTM language model."""

from repro_torch.models import kv_cache  # noqa: F401
from repro_torch.models.encdec import EncDecLM  # noqa: F401
from repro_torch.models.hybrid import HybridLM  # noqa: F401
from repro_torch.models.registry import build_model  # noqa: F401
from repro_torch.models.transformer import DecoderLM  # noqa: F401
from repro_torch.models.xlstm_model import XLSTMLM  # noqa: F401
