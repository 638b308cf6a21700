"""Activation-sharding context.

Port of ``repro/distributed/context.py``, the parts that change what the
port computes.  The training step sets a spec for the inter-block
activations, as the reference's launcher does: a tuple of mesh axes per
dimension of the ``(B, S, D)`` residual stream, ``(batch axes, "model",
None)`` on a training mesh.  Outside :func:`activation_sharding` the spec
is None and nothing here changes the model.

* :func:`constrain_logits` keeps a vocab-parallel unembed's logits split
  over the tensor axis (the spec's second entry) when a spec is set, as
  the reference's constraint does, so the loss's cross-entropy runs on
  ``(B, S, V/tp)`` float32 pieces and the ``(B, S, V)`` tensor is never
  gathered (``train.step.vocab_parallel_cross_entropy``).  Without a spec
  it gathers them whole.
* The reference's ``block_grad_specs`` and ``tag_block_grads`` constrain
  each layer's weight gradients to the FSDP layout so that XLA
  reduce-scatters them; here the backward of
  ``distributed.collectives.fsdp_gather`` does that, so they have no
  counterpart.
* ``constrain`` (the residual stream split on the sequence over the tensor
  axis between blocks) is not ported yet: the port keeps each rank's
  residual stream whole (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.collectives import TPGroup, vocab_gather

_state = threading.local()


def current_spec() -> Optional[Tuple]:
    return getattr(_state, "spec", None)


@contextlib.contextmanager
def activation_sharding(spec: Optional[Tuple]):
    prev = current_spec()
    _state.spec = spec
    try:
        yield
    finally:
        _state.spec = prev


class VocabShard(NamedTuple):
    """Logits split over the vocabulary: this rank's ``(B, S, V/tp)``
    columns ``[rank·V/tp, (rank+1)·V/tp)`` of ``group``."""
    logits: torch.Tensor
    group: TPGroup


def constrain_logits(logits: torch.Tensor, group: TPGroup):
    """A vocab-parallel unembed's logits (this rank's columns of
    ``group``): a :class:`VocabShard` when the context's spec splits them
    on the tensor axis, else gathered whole."""
    spec = current_spec()
    if spec is None or logits.dim() != 3 or len(spec) < 2 \
            or spec[1] is None:
        return vocab_gather(logits, group)
    return VocabShard(logits, group)
