"""The encoder-decoder translation model (port of ``repro/models``)."""

from repro_torch.models import kv_cache  # noqa: F401
from repro_torch.models.encdec import EncDecLM  # noqa: F401
