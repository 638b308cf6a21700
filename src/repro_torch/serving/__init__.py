"""Static translation serving (port of the ``generate`` half of
``repro/serving``)."""

from repro_torch.serving.engine import GenerationResult, ServingEngine  # noqa: F401
