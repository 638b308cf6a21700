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
config's dtype.  The port keeps its layers unstacked and has no ``remat``
(``configs/base.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ptq import FP_CONTEXT
from repro_torch.data.synthetic import PAD
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over ``mask``; logits (B, S, V) taken in float32; labels
    (B, S)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (logz - gold) * mask
    return torch.sum(ce) / torch.clamp_min(torch.sum(mask), 1.0)


def _lm_loss(model, params, batch, quant) -> Tuple[torch.Tensor, Dict]:
    logits, aux = model.forward(params, batch, quant=quant)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        # enc-dec teacher forcing: predict tgt[t+1]
        labels = F.pad(batch["tgt_tokens"][:, 1:], (0, 1), value=PAD)
    mask = (labels != PAD).to(torch.float32)
    loss = softmax_cross_entropy(logits, labels, mask)
    lb = aux.get("load_balance_loss")
    if lb is None:
        lb = torch.zeros((), dtype=torch.float32, device=loss.device)
    total = loss + 0.01 * lb
    return total, {"ce_loss": loss, "load_balance_loss": lb}


def make_loss_fn(model, quant=None) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"ce_loss", "load_balance_loss"})``."""
    quant = quant or FP_CONTEXT

    def loss_fn(params, batch):
        return _lm_loss(model, params, batch, quant)

    return loss_fn


def _to_bf16(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32 \
            and a.dim() >= 2:
        return a.to(torch.bfloat16)
    return a


def make_train_step(model, optimizer: AdamW, *, accum_steps: int = 1,
                    quant=None, grad_shardings=None,
                    mixed_precision: bool = False) -> Callable:
    """``mixed_precision``: the forward sees bfloat16 copies of the float32
    leaves of rank ≥ 2; the float32 masters stay in the optimizer path.

    ``grad_shardings`` (the reference's FSDP gradient layout) has no
    counterpart on one card."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "gradient shardings need a device mesh (ROADMAP Queue 1: "
            "multi-GPU and the cost accounting)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    base_loss = make_loss_fn(model, quant)
    if mixed_precision:
        def loss_fn(params, batch):
            return base_loss(tree_map(_to_bf16, params), batch)
    else:
        loss_fn = base_loss

    def grad_fn(params, batch):
        """(loss, metrics, float32 gradient leaves) of one batch."""
        inputs = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, inputs), batch)
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
        grads = tree_unflatten(params, grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        metrics["lr"] = optimizer._lr(new_opt.step)
        return (new_params, new_opt), metrics

    return train_step
