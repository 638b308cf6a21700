"""INT8 gradient compression with error feedback.

Port of ``repro/distributed/compression.py``, over a group of data ranks
(a ``distributed.collectives.TPGroup``) instead of an axis name.  The mean
all-reduce is an all-gather of int8 codes plus a local int32 sum: the bytes
on the wire are a quarter of a float32 ring all-reduce's.  Error feedback
adds each step's compression residual to the next step's gradient before
compressing (Karimireddy et al., 2019), so the noise does not pile up.

* The codes come from K1 (``kernels.ops.quantize_static``: the CUDA kernel
  on the card, ``kernels/ref.py`` on the CPU), the function the reference
  spells ``clip(round(x / (max(amax, 1e-12) / 127)), ±127)``.  K1
  multiplies by the float32 reciprocal of the scale where the reference
  divides by it; ``tests/test_torch_compression.py`` counts the codes that
  differ.
* K1 takes its threshold as a host float, so :func:`tree_ef_compressed_mean`
  takes every leaf's ``amax`` in one MAX all-reduce of a stacked vector and
  one host read a call; the values are the reference's per-leaf ``pmax``.
* The gather is exact: each rank writes its codes into its row of a
  zero-filled ``(n, ...)`` int8 buffer and the buffers are SUMmed.

The reference's docstring names a ``dp_compressed`` mode of its training
step, which its ``train/step.py`` does not have; the port's step has none
either (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.core.qtensor import div_exact
from repro_torch.distributed.collectives import TPGroup
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

INT8_MAX = 127.0
EPS = 1e-12


def scale_of(amax: float) -> float:
    """``max(amax, 1e-12) / 127`` in float32, as a host float."""
    return float(np.maximum(np.float32(amax), np.float32(EPS))
                 / np.float32(INT8_MAX))


def compress(x: torch.Tensor, amax: float, *, impl: str = "auto"
             ) -> torch.Tensor:
    """int8 codes of ``x`` at the shared threshold ``amax`` (K1 on the
    leaf as ``(M, K)``; ``impl`` as ``kernels.ops``')."""
    return ops.quantize_static(x, float(amax), impl=impl).data


def _mean(c: torch.Tensor, amax: float, group: TPGroup, n_shards: int,
          impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = scale_of(amax)
    q = compress(c, amax, impl=impl)                       # int8 on the wire
    new_err = c - q.to(torch.float32) * scale              # residual memory
    total = group.all_gather(q[None], 0).to(torch.int32)
    mean = div_exact(torch.sum(total, dim=0).to(torch.float32) * scale,
                     float(n_shards))
    return mean, new_err


def shared_amaxes(cs: List[torch.Tensor], group: TPGroup) -> List[float]:
    """Each leaf's ``max |c|`` over the group: one MAX all-reduce of the
    stacked vector, read once."""
    local = torch.stack([torch.amax(torch.abs(c)) if c.numel()
                         else c.new_zeros(()) for c in cs])
    return group.all_reduce(local, "max").tolist()


def ef_compressed_mean(g: torch.Tensor, err: torch.Tensor, group: TPGroup,
                       n_shards: int, *, impl: str = "auto"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over ``group`` of one gradient leaf:
    (the mean gradient in float32, the new error-feedback state).
    Collective: every rank of ``group`` calls it."""
    c = g.to(torch.float32) + err
    return _mean(c, shared_amaxes([c], group)[0], group, n_shards, impl)


def tree_ef_compressed_mean(grads: Any, err_state: Any, group: TPGroup,
                            n_shards: int, *, impl: str = "auto"
                            ) -> Tuple[Any, Any]:
    """:func:`ef_compressed_mean` over every leaf, the thresholds taken
    together."""
    cs = [g.to(torch.float32) + e for g, e in
          zip(tree_leaves(grads), tree_leaves(err_state))]
    out = [_mean(c, a, group, n_shards, impl)
           for c, a in zip(cs, shared_amaxes(cs, group))]
    return (tree_unflatten(grads, [m for m, _ in out]),
            tree_unflatten(grads, [e for _, e in out]))


def init_error_state(grads: Any) -> Any:
    """Zero float32 residuals shaped as ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def wire_bytes_fp32_allreduce(n_params: int, n_shards: int) -> int:
    """Ring all-reduce: 2·(n-1)/n · N · 4 bytes."""
    return int(2 * (n_shards - 1) / n_shards * n_params * 4)


def wire_bytes_int8_gather(n_params: int, n_shards: int) -> int:
    """All-gather of int8: (n-1)/n · N · 1 byte (each shard sends its copy)."""
    return int((n_shards - 1) / n_shards * n_params * 1)
