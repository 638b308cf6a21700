"""Tensor-parallel serving: the decode state's shards and the rank's local
view of the model.

Port of ``repro/serving/sharding.py``.  Every rank runs the whole engine
loop on the same requests; the scheduler, block tables, page allocator,
prefix cache and spill store stay host-side and identical on every rank.
What splits over the ``tensor`` axis ("model"):

* the K/V pools — paged ``(L, n_pages + 1, ps, HKV, dh)``, contiguous
  ``(L, B, S, HKV, dh)``, cross ``(L, B, enc, HKV, dh)`` and the prefix
  pool — on the heads axis, and their per-token scales ``(..., HKV)``;
* everything else (block tables, cursors, lengths): replicated.

The weights split as ``distributed.sharding.param_specs`` says; an MoE
layer's experts split whole over the axis (expert parallelism), where
their count divides it.

GQA guard: where ``HKV`` does not divide the axis the pools stay whole,
as the K/V projections do (``distributed.sharding``), and the query heads
still split (``distributed.collectives.HeadSlice``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.distributed.collectives import TPGroup, mark_parallel
from repro_torch.distributed.sharding import (  # noqa: F401  (re-exported)
    MESH_ITEM,
    cut,
    kv_pools_shardable,
    local_config,
    param_specs,
    shard_params,
    tp_degree,
)

__all__ = ["MESH_ITEM", "tp_degree", "kv_pools_shardable",
           "decode_state_specs", "shard_decode_state", "mesh_axis_sizes",
           "local_config", "shard_for_serving"]


def mesh_axis_sizes(mesh) -> tuple:
    """Mesh shape as a plain tuple in axis order, for ServeResult."""
    return tuple(int(mesh.shape[a]) for a in mesh.axis_names)


def _map(fn, node):
    """``fn`` over every tensor of a decode state (dicts, dataclasses,
    sequences; None passes through)."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _map(fn, getattr(node, f.name))
            for f in dataclasses.fields(node)})
    if isinstance(node, (tuple, list)):
        return type(node)(_map(fn, v) for v in node)
    return node


def decode_state_specs(state: Any, *, kv_heads: int, head_dim: int,
                       shard_kv: bool, tensor: str = "model") -> Any:
    """Spec tree matching ``state`` (pools on heads, the rest replicated,
    ``()``).  Leaves are recognised by structure: every head-carrying
    tensor of a decode state is rank-5 ``(..., HKV, dh)`` and every quant
    scale a rank-4 float ``(..., HKV)``."""
    def spec(x):
        if not shard_kv:
            return ()
        shape = tuple(x.shape)
        if len(shape) == 5 and shape[-2] == kv_heads and shape[-1] == head_dim:
            return (None, None, None, tensor, None)
        if len(shape) == 4 and shape[-1] == kv_heads and x.is_floating_point():
            return (None, None, None, tensor)
        return ()

    return _map(spec, state)


def shard_decode_state(state: Any, mesh, *, kv_heads: int, head_dim: int,
                       tensor: str = "model") -> Any:
    """This rank's shard of a fresh decode state: the pools cut to its
    heads (contiguous copies), the rest as it is.  The counterpart of the
    reference's ``decode_state_shardings``."""
    if not kv_pools_shardable(mesh, kv_heads, tensor):
        return state
    coords = dict(mesh.coords)

    def one(x):
        spec = decode_state_specs(x, kv_heads=kv_heads, head_dim=head_dim,
                                  shard_kv=True, tensor=tensor)
        return cut(x, spec, mesh, coords) if spec else x

    return _map(one, state)


def shard_for_serving(params: Any, mesh, cfg, tensor: str = "model"
                      ) -> Tuple[Any, Any]:
    """``(local params, local config)`` of this rank: the full tree cut by
    ``param_specs(..., fsdp=None)`` (weights resident, as the reference's
    engine places them) and marked with the collectives its layers run.
    The local config comes first: it refuses what does not split."""
    local_cfg = local_config(cfg, mesh, tensor)
    specs = param_specs(params, mesh, tensor=tensor, fsdp=None,
                        kv_heads=cfg.n_kv_heads)
    local = shard_params(params, specs, mesh, mesh.coords)
    group = TPGroup(rank=int(mesh.coords[tensor]),
                    size=tp_degree(mesh, tensor),
                    group=mesh.group(tensor) if tensor in mesh.axis_names
                    else None)
    local = mark_parallel(local, specs, group, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, tensor=tensor)
    return local, local_cfg
