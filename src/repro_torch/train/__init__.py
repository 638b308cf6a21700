"""Training (port of ``repro/train``)."""

from repro_torch.train.loop import train_loop  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    make_loss_fn,
    make_train_step,
    softmax_cross_entropy,
)
