"""AdamW with global-norm clipping over the port's parameter trees.

Port of ``repro/optim/adamw.py``.  The state mirrors the parameter tree
(``m`` and ``v`` per leaf) and ``step`` is an int32 scalar tensor on the
parameters' device.  ``update`` is functional: it returns new parameters
and a new state and leaves its inputs as they were.

The update is the reference's, op for op in float32: clip the gradients by
their global norm, ``m = b1·m + (1 − b1)·g``, ``v = b2·v + (1 − b2)·g²``,
bias correction by ``1 / (1 − b ** step)``, and weight decay on leaves of
rank ≥ 2 only.  Each elementwise product and sum is rounded as the
reference rounds it (no fused multiply-add, no ``alpha=`` form), over the
leaves in ``torch._foreach_*`` groups, which do not change an element's
value.  The global norm is the norm of the leaves' norms, summed in
another order than the reference's Python ``sum`` of squares, so it agrees
to rounding (``tests/test_torch_train_substrate.py`` states the tolerance).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.qtensor import rdiv_exact
from repro_torch.optim.schedule import _f32
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(torch.zeros_like, params),
            v=tree_map(torch.zeros_like, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step).to(torch.float32)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    def update(self, grads, state: AdamWState, params,
               norm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, AdamWState]:
        """``norm``: the gradients' global norm where the caller has it (a
        sharded step's, each piece of a leaf counted once across the mesh);
        by default :func:`global_norm` of ``grads``."""
        step = state.step + 1
        p = tree_leaves(params)
        g = tree_leaves(grads)
        if self.clip_norm is not None:
            gnorm = global_norm(g) if norm is None else norm
            scale = torch.clamp_max(
                rdiv_exact(float(self.clip_norm), gnorm + 1e-9), 1.0)
            g = torch._foreach_mul(g, scale)
        else:
            g = [x.clone() for x in g]
        # g is this call's own now: it and t are the only scratch trees
        # (a full-width MoE tree is 5.3 GB), reused in place below; an
        # in-place product rounds as the out-of-place one does
        b1, b2 = self.b1, self.b2
        t = torch._foreach_mul(g, g)
        torch._foreach_mul_(t, 1 - b2)
        v = torch._foreach_mul(tree_leaves(state.v), b2)
        torch._foreach_add_(v, t)
        torch._foreach_mul_(g, 1 - b1)
        m = torch._foreach_mul(tree_leaves(state.m), b1)
        torch._foreach_add_(m, g)
        sf = step.to(torch.float32)
        one = _f32(1.0, sf)
        mh_scale = torch.div(one, 1 - torch.pow(_f32(b1, sf), sf))
        vh_scale = torch.div(one, 1 - torch.pow(_f32(b2, sf), sf))
        lr = self._lr(step)

        den, u = t, g
        torch._foreach_copy_(den, v)
        torch._foreach_mul_(den, vh_scale)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_copy_(u, m)
        torch._foreach_mul_(u, mh_scale)
        torch._foreach_div_(u, den)
        if self.weight_decay:                      # decay matrices only
            mats = [i for i, x in enumerate(p) if x.dim() >= 2]
            decay = [den[i] for i in mats]
            torch._foreach_copy_(decay, [p[i] for i in mats])
            torch._foreach_mul_(decay, self.weight_decay)
            torch._foreach_add_([u[i] for i in mats], decay)
        torch._foreach_mul_(u, lr)
        new_p = torch._foreach_sub(p, u)
        return (tree_unflatten(params, new_p),
                AdamWState(step=step, m=tree_unflatten(state.m, m),
                           v=tree_unflatten(state.v, v)))


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of all leaves together: each leaf's norm in one
    multi-tensor launch, then the norm of those norms."""
    leaves = [x.to(torch.float32) for x in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))
