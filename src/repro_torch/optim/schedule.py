"""LR schedules: transformer inverse-sqrt (Vaswani) and warmup-cosine.

Port of ``repro/optim/schedule.py``.  A schedule takes the optimizer's
step, an int32 tensor, and returns a float32 tensor on the step's device;
the arithmetic is the reference's, in float32, with each Python constant
(``d_model ** -0.5``, ``warmup ** -1.5``, ``peak``) rounded to float32
before it meets the step, as JAX's weak types round it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.qtensor import div_exact


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, written by a fill kernel (a
    host-to-card copy would wait for the card)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def inverse_sqrt(d_model: int, warmup: int = 4000):
    """The paper's model's original schedule."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.clamp_min(step.to(torch.float32), 1.0)
        return _f32(d_model ** -0.5, s) * torch.minimum(
            torch.rsqrt(s), s * _f32(warmup ** -1.5, s))
    return lr


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = div_exact(_f32(peak, s) * s, float(max(warmup, 1)))
        frac = torch.clamp(div_exact(s - warmup, float(max(total - warmup, 1))),
                           0.0, 1.0)
        cos = _f32(peak, s) * (_f32(floor, s) + _f32((1 - floor) * 0.5, s)
                               * (1 + torch.cos(_f32(math.pi, s) * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr
