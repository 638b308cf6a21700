"""Optimizer and learning-rate schedules (port of ``repro/optim``)."""

from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: F401
from repro_torch.optim.schedule import inverse_sqrt, warmup_cosine  # noqa: F401
