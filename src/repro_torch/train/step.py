"""Training step: loss, gradient accumulation, mixed precision.

Port of ``repro/train/step.py``.  ``make_train_step`` builds the step for
any model of the port:

    step = make_train_step(model, optimizer, accum_steps=4)
    (params, opt_state), metrics = step(params, opt_state, batch)

The step is functional, as the reference's: it returns new trees and
leaves its inputs unchanged.  Gradients come from ``torch.autograd`` over
detached copies of the parameter leaves; accumulation runs the
microbatches in order and sums their float32 gradients in that order (the
reference's ``lax.scan``).  Parameters stay float32; activations run in the
config's dtype.  The port keeps its layers unstacked; ``cfg.remat``
recomputes each block in the backward (``distributed.context.run_layers``).

On a mesh (``grad_shardings``, a ``distributed.sharding.TreeSharding`` of
``launch.specs.train_arg_specs``' parameter specs) the step runs on every
rank of a ``(data, model)`` mesh of ``torch.distributed`` processes, each
holding its FSDP × tensor-parallel shard of the parameters and of AdamW's
state (:class:`_MeshStep`).  It computes what the reference's step computes
under GSPMD: the same loss over the global batch, the same gradients, each
rank's shard of the same update.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ptq import FP_CONTEXT
from repro_torch.data.synthetic import PAD
from repro_torch.distributed.collectives import (
    TPGroup,
    fsdp_gather,
    gqa_partial_leaves,
    mark_parallel,
    tp_enter,
)
from repro_torch.distributed.context import (
    BlockShard,
    VocabShard,
    activation_sharding,
    prepare_remat,
)
from repro_torch.distributed.sharding import (
    MESH_ITEM,
    _coordinate,
    local_config,
    owns,
    spec_leaves,
)
from repro_torch.launch.mesh import batch_axes
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.tree import tree_leaves, tree_unflatten


def softmax_cross_entropy(logits, labels: torch.Tensor, mask: torch.Tensor,
                          count: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE over ``mask``; logits (B, S, V) taken in float32, or a
    ``distributed.context.VocabShard`` of them
    (:func:`vocab_parallel_cross_entropy`); labels (B, S).  ``count``: the
    mask's count over the whole global batch where these are one rank's
    rows of it; by default the mask's own."""
    denom = torch.clamp_min(torch.sum(mask) if count is None else count, 1.0)
    if isinstance(logits, VocabShard):
        return vocab_parallel_cross_entropy(logits, labels, mask, denom)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (logz - gold) * mask
    return torch.sum(ce) / denom


class _VocabParallelCE(torch.autograd.Function):
    """``sum((logsumexp(x) − x[label]) · mask) / denom`` over logits split
    on the vocabulary: the row max by a MAX over the group, the sum of
    exponentials by a SUM, the gold logit from the rank that owns it by a
    SUM.  The gradient, ``(softmax − onehot) · mask / denom``, stays in
    this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, mask, denom, group):
        v = logits.shape[-1]
        m = group.all_reduce(torch.amax(logits, dim=-1), "max")
        p = torch.exp(logits - m[..., None])
        total = group.all_reduce(torch.sum(p, dim=-1))
        local = labels.long() - group.rank * v
        mine = (local >= 0) & (local < v)
        idx = torch.where(mine, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = group.all_reduce(torch.where(mine, gold,
                                            torch.zeros_like(gold)))
        ce = (m + torch.log(total) - gold) * mask
        p /= total[..., None]
        ctx.save_for_backward(p, idx, mine, mask, denom)
        return torch.sum(ce) / denom

    @staticmethod
    def backward(ctx, g):
        p, idx, mine, mask, denom = ctx.saved_tensors
        w = mask * (g / denom)
        d = p * w[..., None]
        d.scatter_add_(-1, idx[..., None], -(w * mine)[..., None])
        return d, None, None, None, None


def vocab_parallel_cross_entropy(shard: VocabShard, labels: torch.Tensor,
                                 mask: torch.Tensor, denom: torch.Tensor
                                 ) -> torch.Tensor:
    """The masked CE sum over ``denom`` of logits split over the vocabulary
    (this rank's ``(B, S, V/tp)`` float32 columns): the ``(B, S, V)``
    tensor is never gathered."""
    return _VocabParallelCE.apply(shard.logits.to(torch.float32), labels,
                                  mask, denom, shard.group)


def _labels_and_mask(batch) -> Tuple[torch.Tensor, torch.Tensor]:
    if "labels" in batch:
        labels = batch["labels"]
    else:
        # enc-dec teacher forcing: predict tgt[t+1]
        labels = F.pad(batch["tgt_tokens"][:, 1:], (0, 1), value=PAD)
    return labels, (labels != PAD).to(torch.float32)


def _lm_loss(model, params, batch, quant, count=None
             ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = model.forward(params, batch, quant=quant)
    labels, mask = _labels_and_mask(batch)
    loss = softmax_cross_entropy(logits, labels, mask, count)
    lb = aux.get("load_balance_loss")
    if lb is None:
        lb = torch.zeros((), dtype=torch.float32, device=loss.device)
    total = loss + 0.01 * lb
    return total, {"ce_loss": loss, "load_balance_loss": lb}


def make_loss_fn(model, quant=None) -> Callable:
    """``loss_fn(params, batch[, count]) -> (loss, {"ce_loss",
    "load_balance_loss"})``; ``count`` as :func:`softmax_cross_entropy`'s."""
    quant = quant or FP_CONTEXT

    def loss_fn(params, batch, count=None):
        return _lm_loss(model, params, batch, quant, count)

    return loss_fn


def _to_bf16(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32 \
            and a.dim() >= 2:
        return a.to(torch.bfloat16)
    return a


class _MeshStep:
    """What a step on a mesh does beyond the plain step.

    * **Rows.**  Each rank takes its rows of the global batch, of each
      microbatch of it with ``accum_steps`` (the reference's ``reshape(accum,
      B/accum)`` cut), and the loss is one mean over the global batch: the
      masked CE sum over the mask's count SUMmed over the data group (an
      exact integer sum), so the ranks' gradients sum to the unsharded ones.
    * **Parameters.**  Each leaf is made whole over the data group where
      FSDP splits it (``collectives.fsdp_gather``, whose backward
      reduce-scatters its gradient); a leaf the data group holds whole
      passes through ``tp_enter``, whose backward SUMs its gradient over
      the group.  The K/V projections of a GQA-fallback attention
      (``collectives.HeadSlice``) are whole on the tensor axis but each
      rank reads its kv heads only: ``tp_enter`` over the model group too.
      Then the rank's tensor-parallel tree is marked as serving marks it,
      and the model runs with the rank's config
      (``distributed.sharding.local_config``).  A block's leaves are made
      whole as the block runs (``distributed.context.BlockShard``: a
      gather a layer, inside what ``remat`` recomputes); the embedding
      and the final norms at the step's start.
    * **Activations.**  Under the activation sharding ``(batch axes,
      "model", None)`` the residual stream between blocks is each rank's
      ``S/tp`` rows (``distributed.context.run_layers``; a norm's
      parameters there get gradients SUMmed over the tensor axis), and a
      vocab-split unembed keeps its logits split and the CE runs
      vocab-parallel (``distributed.context.constrain_logits``).
    * **MoE.**  The experts split whole over the tensor axis (their
      outputs gathered with a backward that cuts each rank's experts), and
      the load-balance loss and dropped fraction are the global batch's
      (``models.moe.moe_ffn``).
    * **Norm.**  Each piece of a leaf counts once across the mesh: a rank
      adds a leaf's squares only where it :func:`owns` its block.
    """

    def __init__(self, model, layout):
        from repro_torch.models.registry import build_model
        cfg, mesh = model.cfg, layout.mesh
        if cfg.family in ("hybrid", "ssm"):
            raise NotImplementedError(
                f"{cfg.name}: a training step on a mesh runs the dense "
                "and MoE families; the recurrent families are not ported "
                f"yet ({MESH_ITEM})")
        self.mesh, self.specs, self.cfg = mesh, layout.specs, cfg
        self.model = build_model(local_config(cfg, mesh),
                                 device=str(model.device))
        self.axes = batch_axes(mesh)
        d_rank, d_size = _coordinate(self.axes, mesh, mesh.coords)
        self.data = TPGroup(d_rank, d_size, mesh.group(self.axes))
        self.tp = TPGroup(int(mesh.coords["model"]),
                          int(mesh.shape["model"]), mesh.group("model"))
        self.spec = (self.axes, "model", None)

    def leaf_plan(self, params) -> None:
        """Per leaf of this rank's shard: its FSDP dimension, whether its
        gradient is a partial over the tensor axis, whether this rank
        counts it in the norm."""
        specs = spec_leaves(params, self.specs)
        self.fsdp_dims = [next((d for d, e in enumerate(sp) if e is not None
                                and set((e,) if isinstance(e, str) else e)
                                & set(self.axes)), None) for sp in specs]
        self.partial = gqa_partial_leaves(params, self.specs)
        self.owned = [owns(sp, self.mesh, self.mesh.coords) for sp in specs]
        # each top-level node's run of leaves (dict keys in sorted order)
        self.spans, lo = {}, 0
        for k in sorted(params):
            n = len(tree_leaves(params[k]))
            self.spans[k], lo = (lo, lo + n), lo + n

    def rows(self, batch, accum_steps: int):
        """This rank's rows of each of the ``accum_steps`` microbatches of
        the global batch, in order."""
        B = next(iter(batch.values())).shape[0]
        n = accum_steps * self.data.size
        if B % n:
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"into {accum_steps} microbatches over "
                             f"{self.data.size} data ranks")
        mb, part = B // accum_steps, B // n
        dev = next(iter(batch.values())).device
        idx = torch.cat([torch.arange(i * mb + self.data.rank * part,
                                      i * mb + (self.data.rank + 1) * part,
                                      device=dev)
                         for i in range(accum_steps)])
        return {k: v[idx] for k, v in batch.items()}

    def node(self, params, leaves: List[torch.Tensor], key: str):
        """Top-level node ``key`` made whole from this rank's ``leaves``
        and marked."""
        lo, hi = self.spans[key]
        whole = []
        for x, d, partial in zip(leaves[lo:hi], self.fsdp_dims[lo:hi],
                                 self.partial[lo:hi]):
            x = (tp_enter(x, self.data) if d is None
                 else fsdp_gather(x, d, self.data))
            whole.append(tp_enter(x, self.tp) if partial else x)
        return mark_parallel(tree_unflatten(params[key], whole),
                             self.specs[key], self.tp,
                             n_heads=self.cfg.n_heads,
                             n_kv_heads=self.cfg.n_kv_heads)

    def loss(self, loss_fn, params, leaves: List[torch.Tensor], batch):
        # the model's block nodes are made whole by its block loop as
        # each runs; the others now
        blocks = set(self.model.block_keys)
        tree = {k: BlockShard(functools.partial(self.node, params, leaves, k))
                if k in blocks else self.node(params, leaves, k)
                for k in params}
        count = self.data.all_reduce(torch.sum(_labels_and_mask(batch)[1]))
        with activation_sharding(self.spec, tp=self.tp, data=self.data):
            return loss_fn(tree, batch, count)

    def metrics(self, loss, metrics):
        """The loss and metrics SUMmed over the data group: equal on every
        rank."""
        keys = sorted(metrics)
        v = self.data.all_reduce(torch.stack([loss] + [metrics[k]
                                                       for k in keys]))
        return v[0], dict(zip(keys, v[1:]))

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        sq = torch.stack(torch._foreach_norm(grads)).square()
        sq = sq * torch.tensor(self.owned, dtype=sq.dtype, device=sq.device)
        sq = self.tp.all_reduce(self.data.all_reduce(sq))
        return torch.linalg.vector_norm(torch.sqrt(sq))


def make_train_step(model, optimizer: AdamW, *, accum_steps: int = 1,
                    quant=None, grad_shardings=None,
                    mixed_precision: bool = False) -> Callable:
    """``mixed_precision``: the forward sees bfloat16 copies of the float32
    leaves of rank ≥ 2 (cast before an FSDP gather, which then moves half
    the bytes); the float32 masters stay in the optimizer path.

    ``grad_shardings``: a ``distributed.sharding.TreeSharding`` — the
    parameter specs of ``launch.specs.train_arg_specs`` and their mesh.
    The step then runs on each rank of the mesh (:class:`_MeshStep`): it
    takes and returns the rank's shards of the parameters and of the
    optimizer state, and the global batch; ``loss``, ``ce_loss``,
    ``grad_norm`` and ``lr`` are equal on every rank.  The step carries
    ``grad_shardings`` as an attribute (``train.loop.train_loop`` saves
    and restores through it)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if model.cfg.remat:
        prepare_remat()
    mesh = None if grad_shardings is None else _MeshStep(model, grad_shardings)
    loss_fn = make_loss_fn(model if mesh is None else mesh.model, quant)
    cast = _to_bf16 if mixed_precision else (lambda a: a)

    def grad_fn(params, batch):
        """(loss, metrics, float32 gradient leaves) of one batch."""
        inputs = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        with torch.enable_grad():
            used = [cast(x) for x in inputs]
            if mesh is None:
                loss, metrics = loss_fn(tree_unflatten(params, used), batch)
            else:
                loss, metrics = mesh.loss(loss_fn, params, used, batch)
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x, dtype=torch.float32) if g is None
                 else g.to(torch.float32) for x, g in zip(inputs, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state: AdamWState, batch
                   ) -> Tuple[Tuple[Any, AdamWState], Dict[str, torch.Tensor]]:
        device = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if mesh is not None:
            mesh.leaf_plan(params)
            batch = mesh.rows(batch, accum_steps)
        if accum_steps == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % accum_steps:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{accum_steps} microbatches")
            mb = B // accum_steps
            grads, loss, ms = None, None, []
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, m, g = grad_fn(params, micro)
                if grads is None:
                    grads, loss = g, l
                else:
                    torch._foreach_add_(grads, g)
                    loss = loss + l
                ms.append(m)
            n = torch.full((), float(accum_steps), dtype=torch.float32,
                           device=device)
            grads = [torch.div(g, n) for g in grads]
            loss = loss / n
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        gnorm = global_norm(grads) if mesh is None else mesh.norm(grads)
        if mesh is not None:
            loss, metrics = mesh.metrics(loss, metrics)
        grads = tree_unflatten(params, grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               norm=gnorm)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        metrics["lr"] = optimizer._lr(new_opt.step)
        return (new_params, new_opt), metrics

    train_step.grad_shardings = grad_shardings
    return train_step
