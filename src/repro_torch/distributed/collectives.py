"""Tensor-parallel collectives, and the marks that tell a sharded layer
which of them to run.

Every collective is an ``all_reduce``: SUM, or MAX where asked.  An
all-gather is a SUM into a zero-filled buffer in which each rank has
written its own slice; ``x + 0`` is ``x``, so it is exact for integers and
floats.  One body then serves gloo on the CPU, gloo with CUDA tensors on
one card (gloo has no CUDA ``all_gather``) and NCCL across cards.  The
backend is the caller's choice (``init_process_group``); a collective that
fails raises, and nothing falls back to a whole-weight compute.

Training needs collectives that autograd sees.  Each is a
``torch.autograd.Function`` built on the same two reductions:

* :func:`fsdp_gather` — forward: the whole leaf over the data group;
  backward: SUM over the group, then this rank's slice (a reduce-scatter);
* :func:`tp_enter` — forward: identity; backward: SUM over the group;
* :func:`tp_row_sum` — forward: SUM over the group; backward: identity;
* :func:`tp_gather` — forward: the ranks' slices of a dimension
  concatenated; backward: this rank's slice (:func:`vocab_gather` on the
  last dimension);
* :func:`tp_split` — forward: this rank's slice of a value every rank
  holds whole; backward: the ranks' slices gathered;
* :func:`data_sum` — forward and backward: SUM over the group.

``tp_enter`` goes where a replicated activation meets a column-split
projection (each rank's input gradient is a partial sum); it also carries a
leaf that the data group holds whole, whose gradient the ranks' rows each
give a part of.  ``tp_row_sum`` is a row-parallel projection's exit.
Under the sequence-split residual (``distributed.context.run_layers``) a
block's input rows are gathered with ``fsdp_gather`` on the sequence
instead of ``tp_enter``, and its whole output cut back with ``tp_split``.

:func:`mark_parallel` adds a ``"tp"`` entry to the nodes of a rank's shard
(``distributed.sharding.shard_params``) that need a collective:

* ``Parallel("row")`` — an out-projection split on its input features:
  ``models.layers.dense`` reduces its partial products across the group;
* ``Parallel("gather")`` — a replicated weight behind a split producer (an
  INT4 out-projection, whose rows the rules never split): the input is
  gathered first;
* ``Parallel("vocab")`` — a vocab-split embedding table: a masked lookup
  plus a SUM, and logits gathered over the vocabulary;
* ``Parallel("expert")`` on an MoE layer's ``experts`` node — the experts
  split whole (expert parallelism): this rank holds experts ``[rank·E/tp,
  (rank+1)·E/tp)``, runs them on their rows of the dispatch and gathers
  the experts' outputs (``models.moe.moe_ffn``);
* ``HeadSlice`` on an attention node — the GQA fallback, where the kv heads
  do not divide the group: the K/V projections and pools stay whole and
  this rank's query heads read kv heads ``[lo, lo + n)`` of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.qtensor import BlockQTensor, QTensor
from repro_torch.distributed.sharding import IN_PROJ, OUT_PROJ, axis_dim

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """This rank's place in a group of ranks along one mesh axis (the
    tensor-parallel "model" group, or the data group of a training
    mesh)."""
    rank: int
    size: int
    group: Optional[Any] = None      # a ProcessGroup (None: the default)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the group, in place."""
        if self.size > 1:
            dist.all_reduce(x, op=_OPS[op], group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        dim = dim % x.dim()
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.narrow(dim, self.rank * n, n).copy_(x)
        return self.all_reduce(out)



class _Gather(torch.autograd.Function):
    """The ranks' ``x`` concatenated along ``dim``; the gradient SUMmed
    over the group and cut back to this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.all_reduce(g.contiguous().clone())
        return (g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
                .contiguous(), None, None)


class _Enter(torch.autograd.Function):
    """Identity; the gradient SUMmed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _RowSum(torch.autograd.Function):
    """The ranks' ``x`` SUMmed; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceGather(torch.autograd.Function):
    """The ranks' slices of ``dim`` concatenated; the gradient cut to this
    rank's slice (every rank's gradient of the whole is the same)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
                .contiguous(), None, None)


class _Split(torch.autograd.Function):
    """This rank's slice of ``dim`` of a value every rank holds whole; the
    gradient's slices gathered from the ranks."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = x.shape[dim] // group.size
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, group.rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous(), ctx.dim), None, None


class _Sum(torch.autograd.Function):
    """The ranks' ``x`` SUMmed; the gradient SUMmed too (each rank's loss
    reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


def _recording(x: torch.Tensor) -> bool:
    """True where autograd records ``x``'s history (training).  Elsewhere
    the functions below run their forward reduction alone, as serving
    always has."""
    return torch.is_grad_enabled() and x.requires_grad


def fsdp_gather(x: torch.Tensor, dim: int, group: TPGroup) -> torch.Tensor:
    """An FSDP-split leaf whole over the data group; its gradient
    reduce-scattered back to this rank's slice (the reference's
    ``grad_shardings`` and ``tag_block_grads``)."""
    if group.size == 1:
        return x
    if not _recording(x):
        return group.all_gather(x, dim)
    return _Gather.apply(x, dim % x.dim(), group)


def tp_enter(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """``x`` unchanged; its gradient SUMmed over ``group``."""
    if group.size == 1 or not _recording(x):
        return x
    return _Enter.apply(x, group)


def tp_row_sum(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """The SUM over ``group`` of the ranks' partial ``x`` (in place unless
    autograd records it); the gradient reaches every rank's part whole."""
    if group.size == 1:
        return x
    if not _recording(x):
        return group.all_reduce(x)
    return _RowSum.apply(x, group)


def tp_gather(x: torch.Tensor, dim: int, group: TPGroup) -> torch.Tensor:
    """The ranks' slices of ``dim`` concatenated; the gradient cut back to
    this rank's slice, for a whole value whose gradient every rank holds
    the same (the experts' outputs, a block's rows made whole again)."""
    if group.size == 1:
        return x
    if not _recording(x):
        return group.all_gather(x, dim)
    return _SliceGather.apply(x, dim % x.dim(), group)


def vocab_gather(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """Vocab-split logits gathered along the last dimension."""
    return tp_gather(x, -1, group)


def tp_split(x: torch.Tensor, dim: int, group: TPGroup) -> torch.Tensor:
    """This rank's ``1/size`` slice of ``dim`` of a value every rank of
    ``group`` holds whole (a view where autograd does not record); its
    gradient is the ranks' slices gathered."""
    if group.size == 1:
        return x
    if not _recording(x):
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n)
    return _Split.apply(x, dim % x.dim(), group)


def data_sum(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """The SUM of the ranks' ``x`` where every rank's loss reads the sum
    (a statistic over the global batch): the gradient is SUMmed too."""
    if group.size == 1:
        return x
    if not _recording(x):
        return group.all_reduce(x.clone())
    return _Sum.apply(x, group)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """The collective a sharded linear or embedding node runs."""
    kind: str                        # "row" | "gather" | "vocab" | "expert"
    group: TPGroup


@dataclasses.dataclass(frozen=True)
class HeadSlice:
    """GQA fallback: this rank's query heads read kv heads [lo, lo + n)."""
    lo: int
    n: int


def _w_spec(spec_node) -> Optional[tuple]:
    w = spec_node.get("w") if isinstance(spec_node, dict) else None
    return w.data if isinstance(w, (QTensor, BlockQTensor)) else w


def _splits(spec_node, dim: int, tensor: str) -> bool:
    w = _w_spec(spec_node)
    return w is not None and axis_dim(w, tensor) == len(w) + dim


def head_slice(rank: int, tp: int, n_heads: int, n_kv_heads: int
               ) -> HeadSlice:
    """The kv heads rank ``rank``'s query heads read when the kv heads stay
    whole; raises unless they are ``n`` consecutive heads each serving an
    equal run of the rank's query heads (every case with
    ``G % (H / tp) == 0``, ``G = H / HKV``)."""
    h = n_heads // tp
    g = n_heads // n_kv_heads
    q0 = rank * h
    kv = [(q0 + i) // g for i in range(h)]
    lo, n = kv[0], kv[-1] - kv[0] + 1
    if h % n or any(kv[i] - lo != i // (h // n) for i in range(h)):
        raise NotImplementedError(
            f"{n_heads} query heads over {n_kv_heads} kv heads on {tp} "
            f"ranks: rank {rank}'s query heads do not map onto an even run "
            "of kv heads")
    return HeadSlice(lo, n)


def mark_parallel(params: Any, specs: Any, group: TPGroup, *,
                  n_heads: int, n_kv_heads: int,
                  tensor: str = "model") -> Any:
    """A copy of a rank's shard with the ``"tp"`` marks (module docstring)
    its layers read; ``specs`` is the full tree's
    ``distributed.sharding.param_specs``."""
    if group.size == 1 or not isinstance(params, dict):
        return params
    out = {k: mark_parallel(v, specs[k], group, n_heads=n_heads,
                            n_kv_heads=n_kv_heads, tensor=tensor)
           if isinstance(v, dict) else v for k, v in params.items()}
    producer = any(_splits(specs[k], -1, tensor) for k in params
                   if k in IN_PROJ)
    for k in params:
        if k in OUT_PROJ and isinstance(params[k], dict):
            kind = ("row" if _splits(specs[k], -2, tensor)
                    else "gather" if producer else None)
            if kind:
                out[k] = dict(out[k], tp=Parallel(kind, group))
    # the stacked expert axis (before the core two) takes the tensor axis
    if isinstance(params.get("experts"), dict) and _splits(
            specs["experts"].get("gate"), -3, tensor):
        out["experts"] = dict(out["experts"], tp=Parallel("expert", group))
    if "table" in params and axis_dim(specs["table"], tensor) == 0:
        out["tp"] = Parallel("vocab", group)
    if ("q_proj" in params and _splits(specs["q_proj"], -1, tensor)
            and not _splits(specs["k_proj"], -1, tensor)):
        out["tp"] = head_slice(group.rank, group.size, n_heads, n_kv_heads)
    return out


def gqa_partial_leaves(params: Any, specs: Any, tensor: str = "model"
                       ) -> list:
    """Per float leaf of ``params`` (``tree.tree_leaves`` order): True for
    the K/V projections of a GQA-fallback attention (:class:`HeadSlice`),
    which every rank of the tensor axis holds whole but reads only its kv
    heads of, so each rank's gradient is a partial to SUM over the axis."""
    if isinstance(params, torch.Tensor):
        return [False]
    if not isinstance(params, dict):
        return []
    gqa = ("q_proj" in params and _splits(specs["q_proj"], -1, tensor)
           and not _splits(specs["k_proj"], -1, tensor))
    out = []
    for k in sorted(params):
        sub = gqa_partial_leaves(params[k], specs[k], tensor)
        out += [True] * len(sub) if gqa and k in ("k_proj", "v_proj") \
            else sub
    return out
