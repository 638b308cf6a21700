"""Carry the JAX package's weights and calibrations into the port.

``params_from_flat`` takes the reference's parameters as a flat dict of
numpy arrays keyed the way ``repro/checkpoint/checkpointer.py``
(``_flatten_with_paths``) keys them — ``"enc_blocks.0/attn/q_proj/w"``, and
for a ``QTensor`` weight ``".../w/0"`` (int8 data), ``".../w/1"`` (keepdims
per-column scale) and ``".../w/2"`` (zero point) — and returns the port's
nested parameter dict on ``device``.  A scan-stacked tree (``enc_blocks``,
``dec_blocks``, the decoder-only ``blocks`` or the hybrid's ``mamba``, with
a leading layer axis) is split into the port's per-layer nodes
(``enc_blocks.{i}``, ``mamba.{i}``, ...); only that axis splits, so MoE
expert weights keep their expert axis ((L, E, K, N) → (E, K, N), and their
scales (L, E, 1, N) → (E, 1, N)).  The xLSTM's stacked groups, ``mlstm``
(G, M, ...) and ``slstm`` (G, ...), become ``blocks.{g (M + 1) + j}`` and
``blocks.{g (M + 1) + M}``, the layer order of its unstacked tree.

A ``BlockQTensor`` (INT4) weight is flattened under the same three keys
(packed nibbles, block scales, block minimums) without its ``group_size``
and ``k_dim``; with one group its leaves even have a ``QTensor``'s shapes.
So the caller names those sites in ``block_meta`` (``{site: (group_size,
k_dim)}``, e.g. from :func:`block_meta_of` on the reference's tree), and a
triple that is not named there and does not look like a symmetric
``QTensor`` (f32 keepdims scale, zero point all zero) is refused rather
than guessed.

``calibrations_from_reference`` copies a ``{site: SiteCalibration}`` dict
(any objects with the reference's attributes) into the port's records, so
both packages quantize activations with identical thresholds.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.calibration import SiteCalibration
from repro_torch.core.histogram import HistogramClass
from repro_torch.core.qtensor import BlockQTensor, QTensor
from repro_torch.core.quantize import Thresholds

_STACKED = re.compile(r"^(enc_blocks|dec_blocks|blocks|mamba)$")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy twin in torch
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _insert(tree: Dict[str, Any], path, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def block_meta_of(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
                  ) -> Dict[str, Tuple[int, int]]:
    """``{site: (group_size, k_dim)}`` of every block-quantized weight in a
    nested parameter tree (any leaf object with those two attributes)."""
    out: Dict[str, Tuple[int, int]] = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(block_meta_of(v, path))
        elif hasattr(v, "group_size") and hasattr(v, "k_dim"):
            out["/".join(prefix)] = (int(v.group_size), int(v.k_dim))
    return out


def _block_leaf(site: str, leaves, meta: Tuple[int, int],
                device) -> BlockQTensor:
    group_size, k_dim = meta
    data, scale, vmin = (np.asarray(leaves[i]) for i in "012")
    n_g = scale.shape[-2] if scale.ndim >= 2 else -1
    if (data.dtype != np.int8 or scale.dtype not in (np.float16, np.float32)
            or vmin.dtype != scale.dtype or vmin.shape != scale.shape
            or n_g < 1 or 2 * data.shape[-2] != n_g * group_size
            or not 0 < k_dim <= n_g * group_size):
        raise ValueError(
            f"{site}: leaves {data.dtype}{data.shape}, {scale.dtype}"
            f"{scale.shape}, {vmin.dtype}{vmin.shape} are not a BlockQTensor "
            f"of group_size={group_size}, k_dim={k_dim}")
    return BlockQTensor(data=_tensor(data, device),
                        scale=_tensor(scale, device),
                        vmin=_tensor(vmin, device), group_size=group_size,
                        k_dim=k_dim)


def _int8_leaf(site: str, leaves, device) -> QTensor:
    data, scale, zp = (np.asarray(leaves[i]) for i in "012")
    if (data.dtype != np.int8 or scale.dtype != np.float32
            or (scale.ndim and scale.shape[-2:] != (1, data.shape[-1]))
            or np.any(zp != 0)):
        raise ValueError(
            f"{site}: leaves {data.dtype}{data.shape}, {scale.dtype}"
            f"{scale.shape}, zero point {zp.dtype}{zp.shape} are not a "
            "symmetric QTensor; if this is an INT4 weight, name it in "
            "block_meta")
    return QTensor(data=_tensor(data, device),
                   scale=_tensor(scale, device).to(torch.float32),
                   zero_point=_tensor(zp, device).to(torch.float32),
                   axis=None)


def params_from_flat(flat: Mapping[str, np.ndarray], *,
                     device: str = "cuda",
                     block_meta: Optional[Mapping[str, Tuple[int, int]]]
                     = None) -> Dict[str, Any]:
    block_meta = dict(block_meta or {})
    # mLSTM layers a group of a stacked xLSTM tree (its sLSTM layer is last)
    M = next((np.asarray(a).shape[1] for k, a in flat.items()
              if k.split("/")[0] == "mlstm"), 0)
    # per-layer split of stacked roots: "enc_blocks/x/y" → "enc_blocks.{i}/x/y"
    entries = []
    for key, arr in flat.items():
        parts = key.split("/")
        a = np.asarray(arr)
        if _STACKED.match(parts[0]):
            for i in range(a.shape[0]):
                entries.append(([f"{parts[0]}.{i}"] + parts[1:], a[i]))
        elif parts[0] == "mlstm":
            for g, j in np.ndindex(*a.shape[:2]):
                entries.append(([f"blocks.{g * (M + 1) + j}"] + parts[1:],
                                a[g, j]))
        elif parts[0] == "slstm":
            for g in range(a.shape[0]):
                entries.append(([f"blocks.{g * (M + 1) + M}"] + parts[1:],
                                a[g]))
        else:
            entries.append((parts, arr))

    tree: Dict[str, Any] = {}
    qparts: Dict[tuple, Dict[str, np.ndarray]] = {}
    for parts, arr in entries:
        if len(parts) >= 2 and parts[-2] == "w" and parts[-1] in "0 1 2".split():
            qparts.setdefault(tuple(parts[:-1]), {})[parts[-1]] = arr
        else:
            _insert(tree, parts, _tensor(arr, device))
    for path, leaves in qparts.items():
        if set(leaves) != {"0", "1", "2"}:
            raise KeyError(f"quantized leaf {'/'.join(path)} needs three "
                           f"arrays (w/0, w/1, w/2), got {sorted(leaves)}")
        site = "/".join(path[:-1])
        meta = block_meta.pop(site, None)
        _insert(tree, list(path),
                _block_leaf(site, leaves, meta, device) if meta is not None
                else _int8_leaf(site, leaves, device))
    if block_meta:
        raise KeyError(f"block_meta names sites with no quantized weight: "
                       f"{sorted(block_meta)}")
    return tree


def calibrations_from_reference(calibrations: Mapping[str, Any]
                                ) -> Dict[str, SiteCalibration]:
    out = {}
    for site, rec in calibrations.items():
        c = rec.classification
        out[site] = SiteCalibration(
            name=rec.name,
            thresholds=Thresholds(float(rec.thresholds.t_min),
                                  float(rec.thresholds.t_max)),
            classification=HistogramClass(
                kind=str(c.kind), zero_fraction=float(c.zero_fraction),
                occupancy=float(c.occupancy),
                p999_over_amax=float(c.p999_over_amax)),
            quantize=bool(rec.quantize))
    return out
