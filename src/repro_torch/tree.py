"""Pytree helpers over the port's parameter trees (the part of
``jax.tree_util`` the training path needs).

A tree is built from dicts, tuples, lists, NamedTuples (``AdamWState``),
:class:`~repro_torch.core.qtensor.QTensor` and
:class:`~repro_torch.core.qtensor.BlockQTensor` nodes; ``None`` is an empty
node, and everything else (a tensor, a Python number, a numpy array) is a
leaf.  Leaves come in JAX's order: dict keys sorted, sequences and
NamedTuple fields in order, a quantized tensor's three arrays in order.

The walks are module-level functions: a nested function that calls itself
is a reference cycle, which would keep its list of leaves (a whole tree of
card memory) alive until the garbage collector runs.

``leaves_with_paths`` names each leaf the way the reference's checkpointer
keys it (``repro/checkpoint/checkpointer.py:_path_str`` over
``jax.tree_util.tree_flatten_with_path``): a dict key as itself, a sequence
index or a quantized tensor's leaf as its index, a NamedTuple field as
``.field``.  So both packages write and read the same ``arrays.npz`` keys,
for example ``1/.m/dec_blocks.0/ffn/in/w``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.qtensor import BlockQTensor, QTensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _kids(node) -> Optional[List[Any]]:
    """The children of an inner node in leaf order; None for a leaf."""
    if isinstance(node, torch.Tensor):
        return None
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    if isinstance(node, QTensor):
        return [node.data, node.scale, node.zero_point]
    if isinstance(node, BlockQTensor):
        return [node.data, node.scale, node.vmin]
    return None


def _segments(node) -> List[str]:
    """The path segments of an inner node's children, in leaf order."""
    if isinstance(node, dict):
        return [str(k) for k in sorted(node)]
    if _is_namedtuple(node):
        return [f".{f}" for f in node._fields]
    return [str(i) for i in range(len(_kids(node)))]


def _rebuild(node, children: List[Any]):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    if isinstance(node, QTensor):
        return QTensor(*children, axis=node.axis)
    return BlockQTensor(*children, group_size=node.group_size,
                        k_dim=node.k_dim)


def _walk_paths(node, path, out: List[Tuple[str, Any]]) -> None:
    if node is None:
        return
    kids = _kids(node)
    if kids is None:
        out.append(("/".join(path), node))
        return
    for seg, child in zip(_segments(node), kids):
        _walk_paths(child, path + (seg,), out)


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in leaf order, ``path`` joined with ``/``."""
    out: List[Tuple[str, Any]] = []
    _walk_paths(tree, (), out)
    return out


def _walk(node, out: List[Any]) -> None:
    if node is None:
        return
    kids = _kids(node)
    if kids is None:
        out.append(node)
    else:
        for child in kids:
            _walk(child, out)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    _walk(tree, out)
    return out


def _build(node, it: Iterator):
    if node is None:
        return None
    kids = _kids(node)
    if kids is None:
        return next(it)
    return _rebuild(node, [_build(c, it) for c in kids])


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it: Iterator = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which share its structure)."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree), *others)])
