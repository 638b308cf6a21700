"""Parameter sharding rules: parameter-tree paths → per-leaf specs, and the
cut of one rank's shard from a full tree.

Port of ``repro/distributed/sharding.py``.  A spec is a tuple with one
entry per dimension of its leaf: ``None`` (replicated), a mesh axis name,
or a tuple of axis names (the dimension splits over their product), the
entries of the reference's ``PartitionSpec``.  The rules are the
reference's:

* the ``tensor`` axis ("model") splits the output features of
  in-projections, the input features of out-projections, the vocabulary,
  the experts and (through the projections) the attention heads;
* the ``fsdp`` axes split the other weight dimension; serving passes
  ``fsdp=None`` (weights resident);
* an axis applies only where the dimension divides evenly (``_fit``): a
  vocab of 49155 stays whole on 16 ranks;
* GQA: where the kv heads do not divide the tensor axis, ``k_proj`` and
  ``v_proj`` replicate;
* INT4 (``BlockQTensor``): the packed rows and the group rows replicate,
  only the output columns split; a QTensor's keepdims scale follows its
  weight except on the contraction dimension.

A mesh here is anything with ``axis_names`` and ``shape[name]`` (a
``launch.mesh.Mesh`` or a test's stand-in).  :func:`gather_params` puts a
sharded tree back together, and :func:`shard_opt_state` cuts an
optimizer state as its parameters; :func:`local_config` is the config a
rank's layers run with.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.qtensor import BlockQTensor, QTensor

# the ROADMAP item, by title, of what does not run on a mesh yet
MESH_ITEM = "ROADMAP Queue 1: multi-GPU and the cost accounting"

IN_PROJ = {"q_proj", "k_proj", "v_proj", "gate", "up", "in", "in_proj",
           "up_proj", "gate_ssm_if"}
OUT_PROJ = {"o_proj", "down", "out", "out_proj", "down_proj"}
ROUTER = {"router"}

Spec = Tuple[Any, ...]


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return int(mesh.shape[axes])
    return int(math.prod(int(mesh.shape[a]) for a in axes))


def _fit(dim: int, axes, mesh):
    """``axes`` if ``dim`` divides the axis product, else None."""
    if axes is None:
        return None
    return axes if dim % _axis_size(mesh, axes) == 0 else None


def _none(rank: int) -> Spec:
    return (None,) * rank


def _base_spec(node_name: str, path: Tuple[str, ...], leaf_name: str,
               shape: Sequence[int], mesh, tensor, fsdp,
               kv_heads: int = 0) -> Spec:
    """Spec of one leaf of a linear or embedding node."""
    is_expert = "experts" in path
    rank = len(shape)
    # GQA: kv heads that do not divide the tensor axis would split a head
    # across ranks; the (small) K/V projections replicate instead
    if node_name in ("k_proj", "v_proj") and tensor is not None and \
            kv_heads and kv_heads % _axis_size(mesh, tensor) != 0:
        tensor = None

    if leaf_name == "table":                       # embedding (V, D)
        if tensor is not None:
            return (_fit(shape[0], tensor, mesh), None)
        return (_fit(shape[0], fsdp, mesh), None)

    if node_name in ROUTER:
        if leaf_name == "b":
            return _none(rank)
        specs = [_fit(shape[-2], fsdp, mesh), None]
    elif node_name in IN_PROJ:
        if leaf_name == "b":
            return _none(rank - 1) + (_fit(shape[-1], tensor, mesh),)
        specs = [_fit(shape[-2], fsdp, mesh), _fit(shape[-1], tensor, mesh)]
    elif node_name in OUT_PROJ:
        if leaf_name == "b":
            return _none(rank)
        specs = [_fit(shape[-2], tensor, mesh), _fit(shape[-1], fsdp, mesh)]
    else:
        return _none(rank)

    lead_rank = rank - 2
    lead: list = [None] * lead_rank
    if is_expert and lead_rank >= 1:
        # the stack dimension before the core two is the expert axis, and
        # expert parallelism takes the tensor axis from the feature dims
        e_fit = _fit(shape[lead_rank - 1], tensor, mesh)
        lead[-1] = e_fit
        if e_fit is not None:
            specs = [None if s == tensor else s for s in specs]
    return tuple(lead) + tuple(specs)


def _qtensor_scale_spec(w_spec: Spec, scale_shape) -> Spec:
    """The scale has the weight's shape with the contraction dim = 1."""
    parts = (list(w_spec) + [None] * len(scale_shape))[:len(scale_shape)]
    return tuple(None if scale_shape[i] == 1 else parts[i]
                 for i in range(len(scale_shape)))


def _rank(v) -> int:
    return v.dim() if isinstance(v, torch.Tensor) else 0


def _leaf_spec(name: str, v, mesh, tensor) -> Spec:
    """A bare array leaf: the conv weights and bias split their channels,
    an sLSTM ``r_weight`` its heads; everything else replicates."""
    shape = tuple(v.shape) if isinstance(v, torch.Tensor) else ()
    if (name == "conv_w" and len(shape) >= 2) or name == "conv_b":
        return _none(len(shape) - 1) + (_fit(shape[-1], tensor, mesh),)
    if name == "r_weight" and len(shape) >= 3:
        return _none(len(shape) - 3) + (_fit(shape[-3], tensor, mesh),
                                        None, None)
    return _none(len(shape))


def param_specs(params: Any, mesh, *, tensor="model",
                fsdp: Optional[Any] = "data", kv_heads: int = 0) -> Any:
    """Tree of specs with the structure of ``params``: a tuple per tensor
    leaf, and a QTensor / BlockQTensor of specs per quantized weight."""

    def linear_name(path):
        # the path ends with the leaf key ("w"); the linear is above it
        return path[-2] if len(path) >= 2 and path[-1] == "w" else \
            (path[-1] if path else "")

    def walk(node, path: Tuple[str, ...]):
        if isinstance(node, BlockQTensor):
            w_spec = _base_spec(linear_name(path), path, "w",
                                node.data.shape, mesh, tensor, fsdp, kv_heads)
            col = _fit(node.data.shape[-1], w_spec[-1] if w_spec else None,
                       mesh)
            col_spec = _none(node.data.dim() - 1) + (col,)
            return BlockQTensor(data=col_spec, scale=col_spec,
                                vmin=col_spec, group_size=node.group_size,
                                k_dim=node.k_dim)
        if isinstance(node, QTensor):
            w_spec = _base_spec(linear_name(path), path, "w",
                                node.data.shape, mesh, tensor, fsdp, kv_heads)
            scale = (_qtensor_scale_spec(w_spec, node.scale.shape)
                     if isinstance(node.scale, torch.Tensor) else ())
            return QTensor(data=w_spec, scale=scale,
                           zero_point=_none(_rank(node.zero_point)),
                           axis=node.axis)
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(v, (dict, QTensor, BlockQTensor)):
                    out[k] = walk(v, path + (k,))
                elif k in ("w", "b", "table", "scale", "bias"):
                    node_name = path[-1] if path else ""
                    if k in ("scale", "bias") and node_name not in IN_PROJ \
                            and node_name not in OUT_PROJ:
                        out[k] = _none(v.dim())          # norm params
                    else:
                        out[k] = _base_spec(node_name, path, k, v.shape,
                                            mesh, tensor, fsdp, kv_heads)
                else:
                    out[k] = _leaf_spec(k, v, mesh, tensor)
            return out
        return node

    return walk(params, ())


def batch_specs(batch: Dict[str, Any], mesh, batch_axes) -> Dict[str, Spec]:
    """Split the leading (batch) dim of every batch leaf (a tensor or a
    numpy array) over ``batch_axes`` where it divides."""
    return {k: ((_fit(a.shape[0], batch_axes, mesh),)
                + _none(len(a.shape) - 1)) if len(a.shape) >= 1 else ()
            for k, a in batch.items()}


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis`` (alone or in a tuple of
    axes), or None."""
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


def _coordinate(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of this rank along a spec entry's axes (row-major
    over a tuple of axes)."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    index, count = 0, 1
    for a in axes:
        n = int(mesh.shape[a])
        index, count = index * n + int(coords[a]), count * n
    return index, count


def cut(t, spec: Spec, mesh, coords: Dict[str, int]):
    """This rank's block of ``t`` under ``spec`` (``coords``: the rank's
    index along each mesh axis), contiguous; a non-tensor passes through."""
    if not isinstance(t, torch.Tensor):
        return t
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = _coordinate(entry, mesh, coords)
        size = t.shape[d] // count
        t = t.narrow(d, index * size, size)
    return t.contiguous()


def shard_params(params: Any, specs: Any, mesh,
                 coords: Dict[str, int]) -> Any:
    """Cut a rank's shard of every leaf of a full tree by ``specs``
    (:func:`param_specs` of the same tree)."""
    if isinstance(params, QTensor):
        return QTensor(data=cut(params.data, specs.data, mesh, coords),
                       scale=cut(params.scale, specs.scale, mesh, coords),
                       zero_point=params.zero_point, axis=params.axis)
    if isinstance(params, BlockQTensor):
        return BlockQTensor(data=cut(params.data, specs.data, mesh, coords),
                            scale=cut(params.scale, specs.scale, mesh,
                                      coords),
                            vmin=cut(params.vmin, specs.vmin, mesh, coords),
                            group_size=params.group_size,
                            k_dim=params.k_dim)
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh, coords)
                for k, v in params.items()}
    return cut(params, specs, mesh, coords)



def owns(spec: Spec, mesh, coords: Dict[str, int]) -> bool:
    """True on one rank of each set that holds the same block under
    ``spec``: coordinate 0 along every mesh axis the spec does not split
    over."""
    split = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    return all(int(coords[a]) == 0 for a in mesh.axis_names
               if a not in split)


def uncut(t, spec: Spec, mesh, coords: Dict[str, int], group=None):
    """The inverse of :func:`cut`: the whole tensor from every rank's
    block.  Each block is written at its place in a zero-filled tensor by
    the rank that :func:`owns` it and the tensors are summed over
    ``group`` (the mesh's ranks; None: the default group), so every
    element is one block's value plus zeros: exact.  Collective: every
    rank of ``group`` calls it."""
    if not isinstance(t, torch.Tensor):
        return t
    places = [(d, *_coordinate(e, mesh, coords))
              for d, e in enumerate(spec) if e is not None]
    shape = list(t.shape)
    for d, _, count in places:
        shape[d] *= count
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    if owns(spec, mesh, coords):
        view = out
        for d, index, _ in places:
            view = view.narrow(d, index * t.shape[d], t.shape[d])
        view.copy_(t)
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def gather_params(shard: Any, specs: Any, mesh, group=None) -> Any:
    """The whole tree from every rank's :func:`shard_params` cut of it,
    bit for bit (:func:`uncut` leaf by leaf): checkpoints, tests and
    checks of a sharded run.  Collective over ``group``."""
    coords = mesh.coords
    if isinstance(shard, QTensor):
        return QTensor(data=uncut(shard.data, specs.data, mesh, coords,
                                  group),
                       scale=uncut(shard.scale, specs.scale, mesh, coords,
                                   group),
                       zero_point=shard.zero_point, axis=shard.axis)
    if isinstance(shard, BlockQTensor):
        return BlockQTensor(
            data=uncut(shard.data, specs.data, mesh, coords, group),
            scale=uncut(shard.scale, specs.scale, mesh, coords, group),
            vmin=uncut(shard.vmin, specs.vmin, mesh, coords, group),
            group_size=shard.group_size, k_dim=shard.k_dim)
    if isinstance(shard, dict):
        return {k: gather_params(shard[k], specs[k], mesh, group)
                for k in sorted(shard)}
    return uncut(shard, specs, mesh, coords, group)


def shard_opt_state(state, specs: Any, mesh, coords: Dict[str, int]):
    """The rank's cut of an ``AdamWState``: ``m`` and ``v`` as the
    parameters (``specs``), the step counter replicated."""
    return state._replace(m=shard_params(state.m, specs, mesh, coords),
                          v=shard_params(state.v, specs, mesh, coords))


def spec_leaves(params: Any, specs: Any) -> List[Spec]:
    """The spec of each tensor leaf of a float tree, in
    ``tree.tree_leaves`` order (dict keys sorted; a tuple or NamedTuple,
    such as ``(params, AdamWState)``, by position)."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in spec_leaves(params[k], specs[k])]
    if isinstance(params, torch.Tensor):
        return [specs]
    if isinstance(params, (tuple, list)):
        return [s for p, sp in zip(params, specs)
                for s in spec_leaves(p, sp)]
    if params is None:
        return []
    raise TypeError(f"a float parameter tree has no {type(params).__name__} "
                    "leaves")


@dataclasses.dataclass(frozen=True)
class TreeSharding:
    """A spec tree (:func:`param_specs`) with its mesh: what the
    reference's tree of ``NamedSharding`` carries, every leaf on one mesh.
    ``train.step.make_train_step`` takes it as ``grad_shardings``."""
    mesh: Any
    specs: Any


def tp_degree(mesh, tensor: str = "model") -> int:
    """Size of the tensor axis (1 when the mesh does not have it)."""
    if mesh is None or tensor not in mesh.axis_names:
        return 1
    return int(mesh.shape[tensor])


def kv_pools_shardable(mesh, kv_heads: int, tensor: str = "model") -> bool:
    """True iff the K/V pools can split their heads over ``tensor``."""
    tp = tp_degree(mesh, tensor)
    return tp > 1 and kv_heads > 0 and kv_heads % tp == 0


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
