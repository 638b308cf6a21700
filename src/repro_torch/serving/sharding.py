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
from repro_torch.distributed.sharding import cut, param_specs, shard_params

__all__ = ["MESH_ITEM", "tp_degree", "kv_pools_shardable",
           "decode_state_specs", "shard_decode_state", "mesh_axis_sizes",
           "local_config", "shard_for_serving"]

# the ROADMAP item, by title, of what is not yet served on a mesh
MESH_ITEM = "ROADMAP Queue 1: multi-GPU and the cost accounting"


def tp_degree(mesh, tensor: str = "model") -> int:
    """Size of the tensor axis (1 when the mesh does not have it)."""
    if mesh is None or tensor not in mesh.axis_names:
        return 1
    return int(mesh.shape[tensor])


def mesh_axis_sizes(mesh) -> tuple:
    """Mesh shape as a plain tuple in axis order, for ServeResult."""
    return tuple(int(mesh.shape[a]) for a in mesh.axis_names)


def kv_pools_shardable(mesh, kv_heads: int, tensor: str = "model") -> bool:
    """True iff the K/V pools can split their heads over ``tensor``."""
    tp = tp_degree(mesh, tensor)
    return tp > 1 and kv_heads > 0 and kv_heads % tp == 0


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


def local_config(cfg, mesh, tensor: str = "model"):
    """The config a rank runs its layers with: ``H/tp`` query heads,
    ``HKV/tp`` kv heads (all ``HKV`` in the GQA fallback), ``d_ff/tp``
    where it divides, and an explicit head dim.

    MoE: the experts split over the axis (``n_experts % tp == 0``, as the
    reference's rule at ``distributed/sharding.py:96-105``), each whole,
    so ``d_ff`` (the expert width) stays; ``n_experts`` stays the full
    count, since every rank routes over all the experts.  Where they do
    not divide, the reference splits the expert features instead, which
    needs K7 split on K like K3: not ported yet."""
    tp = tp_degree(mesh, tensor)
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads do not split "
                         f"over {tp} ranks")
    moe = cfg.moe is not None
    if moe and cfg.moe.n_experts % tp:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.moe.n_experts} experts do not split over "
            f"{tp} ranks, and splitting their features needs a split K7 "
            f"({MESH_ITEM})")
    hkv = (cfg.n_kv_heads // tp if kv_pools_shardable(mesh, cfg.n_kv_heads,
                                                       tensor)
           else cfg.n_kv_heads)
    d_ff = cfg.d_ff if moe or cfg.d_ff % tp else cfg.d_ff // tp
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp, n_kv_heads=hkv, head_dim=cfg.hd,
        d_ff=d_ff)


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
