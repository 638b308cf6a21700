"""Carry the JAX package's weights and calibrations into the port.

``params_from_flat`` takes the reference's parameters as a flat dict of
numpy arrays keyed the way ``repro/checkpoint/checkpointer.py``
(``_flatten_with_paths``) keys them — ``"enc_blocks.0/attn/q_proj/w"``, and
for a ``QTensor`` weight ``".../w/0"`` (int8 data), ``".../w/1"`` (keepdims
per-column scale) and ``".../w/2"`` (zero point) — and returns the port's
nested parameter dict on ``device``.  A scan-stacked tree (``enc_blocks``
with a leading layer axis) is split into the port's per-layer
``enc_blocks.{i}`` nodes.

``calibrations_from_reference`` copies a ``{site: SiteCalibration}`` dict
(any objects with the reference's attributes) into the port's records, so
both packages quantize activations with identical thresholds.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.calibration import SiteCalibration
from repro_torch.core.histogram import HistogramClass
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantize import Thresholds

_STACKED = re.compile(r"^(enc_blocks|dec_blocks)$")


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


def params_from_flat(flat: Mapping[str, np.ndarray], *,
                     device: str = "cuda") -> Dict[str, Any]:
    # per-layer split of stacked roots: "enc_blocks/x/y" → "enc_blocks.{i}/x/y"
    entries = []
    for key, arr in flat.items():
        parts = key.split("/")
        if _STACKED.match(parts[0]):
            for i in range(np.asarray(arr).shape[0]):
                entries.append(([f"{parts[0]}.{i}"] + parts[1:],
                                np.asarray(arr)[i]))
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
            raise KeyError(f"QTensor leaf {'/'.join(path)} needs data, scale "
                           f"and zero point (w/0, w/1, w/2), got "
                           f"{sorted(leaves)}")
        _insert(tree, list(path), QTensor(
            data=_tensor(leaves["0"], device),
            scale=_tensor(leaves["1"], device).to(torch.float32),
            zero_point=_tensor(leaves["2"], device).to(torch.float32),
            axis=None))
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
