"""Activation-sharding context, and the block loop of a training forward.

Port of ``repro/distributed/context.py``, the parts that change what the
port computes.  The training step sets a spec for the inter-block
activations, as the reference's launcher does: a tuple of mesh axes per
dimension of the ``(B, S, D)`` residual stream, ``(batch axes, "model",
None)`` on a training mesh, with the groups of the tensor axis and of the
batch axes.  Outside :func:`activation_sharding` the spec is None and
nothing here changes the model.

* :func:`constrain_logits` keeps a vocab-parallel unembed's logits split
  over the tensor axis (the spec's second entry) when a spec is set, as
  the reference's constraint does, so the loss's cross-entropy runs on
  ``(B, S, V/tp)`` float32 pieces and the ``(B, S, V)`` tensor is never
  gathered (``train.step.vocab_parallel_cross_entropy``).  Without a spec
  it gathers them whole.
* :func:`run_layers` runs a model's blocks: each under
  ``torch.utils.checkpoint`` where the config asks for ``remat`` (the
  reference's ``jax.checkpoint`` of a scanned block), each block's
  parameters made whole as it enters (a :class:`BlockShard`: the FSDP
  gather a layer), and, where the spec splits the sequence over the
  tensor axis, the residual stream between blocks kept as this rank's
  ``S/tp`` rows (the reference's ``constrain``, Megatron's sequence
  parallelism).
* The reference's ``block_grad_specs`` and ``tag_block_grads`` constrain
  each layer's weight gradients to the FSDP layout so that XLA
  reduce-scatters them; here the backward of
  ``distributed.collectives.fsdp_gather`` does that, so they have no
  counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import sys
import threading
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import (
    TPGroup,
    tp_gather,
    tp_split,
    vocab_gather,
)

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Layout:
    """The activation spec and the groups a training mesh runs with."""
    spec: Tuple
    tp: Optional[TPGroup] = None        # the tensor axis
    data: Optional[TPGroup] = None      # the batch axes


def current_layout() -> Optional[Layout]:
    return getattr(_state, "layout", None)


def current_spec() -> Optional[Tuple]:
    layout = current_layout()
    return None if layout is None else layout.spec


def data_group() -> Optional[TPGroup]:
    """The batch axes' group of a training mesh (None outside one)."""
    layout = current_layout()
    return None if layout is None else layout.data


def sequence_group() -> Optional[TPGroup]:
    """The tensor axis's group while a block runs on this rank's rows of
    a sequence-split residual stream (:func:`run_layers`), else None."""
    return getattr(_state, "rows", None)


@contextlib.contextmanager
def _scope(layout: Optional[Layout], rows: Optional[TPGroup]):
    prev = current_layout(), sequence_group()
    _state.layout, _state.rows = layout, rows
    try:
        yield
    finally:
        _state.layout, _state.rows = prev


@contextlib.contextmanager
def activation_sharding(spec: Optional[Tuple], *,
                        tp: Optional[TPGroup] = None,
                        data: Optional[TPGroup] = None):
    with _scope(None if spec is None else Layout(spec, tp, data), None):
        yield


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


class BlockShard:
    """A block's parameters as one rank of a training mesh holds them;
    ``enter()`` makes them whole (each FSDP-split leaf gathered over the
    data group) and marks them for the tensor-parallel layers.  It is
    called as the block runs, inside the function ``remat`` recomputes,
    so the whole leaves live during the block's forward and its
    recomputation only.  Without ``remat`` autograd keeps every gathered
    leaf for the backward all the same: the gather is a block at a time,
    the memory is not."""
    __slots__ = ("enter",)

    def __init__(self, enter: Callable[[], Any]):
        self.enter = enter


def prepare_remat() -> None:
    """Import what ``torch.utils.checkpoint`` imports at its first call
    (``torch._dynamo``), and collect.  That import leaves its importer's
    stack in cyclic garbage, which inside a step would hold the step's
    trees until a collection; the training step calls this as it is
    built."""
    if "torch._dynamo" not in sys.modules:
        importlib.import_module("torch._dynamo")
        gc.collect()


def _splits_rows(layout: Optional[Layout], x: torch.Tensor) -> bool:
    """Whether the residual ``x`` (B, S, D) runs as this rank's ``S/tp``
    rows: the spec splits the sequence over the tensor axis and ``S``
    divides it (else each rank keeps the stream whole; the math is the
    same)."""
    return (layout is not None and layout.tp is not None
            and layout.tp.size > 1 and len(layout.spec) >= 2
            and layout.spec[1] is not None and x.dim() == 3
            and x.shape[1] % layout.tp.size == 0)


def _block(fn: Callable, params, x: torch.Tensor,
           layout: Optional[Layout], rows: Optional[TPGroup]):
    # runs again, outside the step's activation_sharding, when remat
    # recomputes the block in the backward: the layout, the rows' group
    # and the block's shard are this call's
    with _scope(layout, rows):
        if isinstance(params, BlockShard):
            params = params.enter()
        return fn(params, x)


def run_layers(x: torch.Tensor, layers: Sequence[Tuple[Callable, Any]], *,
               remat: bool) -> Tuple[torch.Tensor, List[Any]]:
    """Run ``layers``, ``[(fn, params)]`` with ``fn(params, x) -> (x,
    aux)``, over the residual stream ``x`` (B, S, D).  Returns the stream
    whole and each block's ``aux``.

    ``remat``, where autograd records the stream (training; the serving
    and calibration forwards record nothing): each block under
    ``torch.utils.checkpoint`` (non-reentrant), so its activations are
    recomputed in the backward and only its input is kept.  The same ops
    run in the same order, so the gradients are the same bits.

    On a training mesh whose spec splits the sequence, the stream is cut
    to this rank's ``S/tp`` rows before the first block
    (``collectives.tp_split``) and gathered after the last
    (``collectives.tp_gather``); inside a block
    (:func:`sequence_group`), ``models.layers.block_input`` gathers the
    rows where they enter the column-split projections and
    ``block_output`` cuts the block's whole output back to them."""
    layout = current_layout()
    rows = layout.tp if _splits_rows(layout, x) else None
    if rows is not None:
        x = tp_split(x, 1, rows)
    auxes = []
    for fn, params in layers:
        if remat and torch.is_grad_enabled() and x.requires_grad:
            x, aux = checkpoint(_block, fn, params, x, layout, rows,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _block(fn, params, x, layout, rows)
        auxes.append(aux)
    if rows is not None:
        x = tp_gather(x, 1, rows)
    return x, auxes
