"""Post-training quantization: FP32/bf16 model → INT8 model (paper §4).

Port of ``repro/core/ptq.py`` at ``weight_bits=8``:

    calibrations = Calibrator(fwd).run(batches).compute(mode="symmetric")
    qparams, qctx = quantize_model(params, calibrations, policy)
    logits = model.forward(qparams, batch, quant=qctx)

``quantize_model`` walks the parameter tree, finds linear nodes (dicts with
a ``"w"`` leaf of rank ≥ 2), and replaces approved weights with
per-output-channel symmetric :class:`QTensor`.  ``QuantContext`` is the
runtime companion the model consults for activation thresholds and the
kernel implementation (``impl``: ``"auto"`` | ``"cuda"`` | ``"torch"``).

Site names are parameter paths: ``dec_blocks.3/self_attn/q_proj``.  A
layer-agnostic name (``dec_blocks.*/self_attn/q_proj``) resolves to the
conservative envelope of the per-layer records, as in the reference.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.calibration import SiteCalibration
from repro_torch.core.histogram import HistogramClass
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qtensor import QTensor, div_exact, rdiv_exact
from repro_torch.core.quantize import QuantMode, Thresholds

_LAYER_SEG = re.compile(r"blocks\.(\d+)")


def generic_site(site: str) -> str:
    """``decoder/blocks.3/attn/q_proj`` → ``decoder/blocks.*/attn/q_proj``."""
    return _LAYER_SEG.sub("blocks.*", site)


def merge_calibrations(records) -> SiteCalibration:
    """Conservative envelope across per-layer records of one generic site."""
    t_min = min(r.thresholds.t_min for r in records)
    t_max = max(r.thresholds.t_max for r in records)
    any_sparse = any(r.classification.kind == "sparse" for r in records)
    kind = "sparse" if any_sparse else records[0].classification.kind
    cls = HistogramClass(
        kind=kind,
        zero_fraction=max(r.classification.zero_fraction for r in records),
        occupancy=min(r.classification.occupancy for r in records),
        p999_over_amax=max(r.classification.p999_over_amax for r in records),
    )
    return SiteCalibration(
        name=generic_site(records[0].name),
        thresholds=Thresholds(t_min, t_max),
        classification=cls,
        quantize=all(r.quantize for r in records),
    )


@dataclasses.dataclass
class QuantContext:
    """Runtime quantization state consulted by the model's linear layers."""

    policy: QuantPolicy
    calibrations: Dict[str, SiteCalibration] = dataclasses.field(
        default_factory=dict)
    impl: str = "auto"           # "auto" | "cuda" | "torch" (kernel choice)
    enabled: bool = True

    def __post_init__(self):
        merged: Dict[str, list] = {}
        for name, rec in self.calibrations.items():
            g = generic_site(name)
            if g != name:
                merged.setdefault(g, []).append(rec)
        for g, records in merged.items():
            if g not in self.calibrations:
                self.calibrations[g] = merge_calibrations(records)

    def lookup(self, site: str) -> Optional[SiteCalibration]:
        rec = self.calibrations.get(site)
        if rec is None:
            rec = self.calibrations.get(generic_site(site))
        return rec

    def activation_thresholds(self, site: str) -> Optional[Thresholds]:
        """Static calibrated thresholds, or None → dynamic quantization."""
        if self.policy.act_quant != "static":
            return None
        rec = self.lookup(site)
        if rec is not None:
            return rec.thresholds
        if self.policy.default_amax is not None:
            t = float(self.policy.default_amax)
            return Thresholds(-t, t)
        return None

    @property
    def quantize_kv(self) -> bool:
        return self.enabled and self.policy.quantize_kv_cache


# A context that disables quantization everywhere (FP32/bf16 baseline).
FP_CONTEXT = QuantContext(policy=QuantPolicy(mode=QuantMode.NONE),
                          enabled=False)


def _is_linear_node(node: Any) -> bool:
    return (isinstance(node, dict) and "w" in node
            and isinstance(node["w"], torch.Tensor) and node["w"].dim() >= 2)


def quantize_weight(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric weight quantization.

    Every linear weight is ``(..., d_in, d_out)``; the scales keep dims
    (``(..., 1, d_out)``).  As in the reference, the codes come from a
    multiplication by ``127 / amax``, not a division by the scale.
    Both divisions are IEEE ones (``qtensor.rdiv_exact``/``div_exact``):
    torch's own ``127.0 / amax`` is ``reciprocal(amax) * 127``.
    """
    wf = w.to(torch.float32)
    amax = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True), 1e-12)
    inv = rdiv_exact(127.0, amax)
    q = torch.clamp(torch.round(wf * inv), -127, 127)
    return QTensor(data=q.to(torch.int8), scale=div_exact(amax, 127.0),
                   zero_point=torch.zeros_like(amax), axis=None)


def _to_device(node: Any, device: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, QTensor):
        move = lambda p: p.to(device) if isinstance(p, torch.Tensor) else p
        return QTensor(move(node.data), move(node.scale),
                       move(node.zero_point), node.axis)
    return node.to(device) if isinstance(node, torch.Tensor) else node


def quantize_model(
    params: Dict[str, Any],
    calibrations: Optional[Dict[str, SiteCalibration]] = None,
    policy: Optional[QuantPolicy] = None,
    impl: str = "auto",
    *,
    weight_bits: int = 8,
    device: str = "cuda",
) -> Tuple[Dict[str, Any], QuantContext]:
    """PTQ transform: returns (quantized params on ``device``, QuantContext).

    Only ``weight_bits=8`` is ported; block-wise INT4 weights are not yet.
    """
    if weight_bits != 8:
        raise ValueError(f"the port quantizes weights to 8 bits only, "
                         f"got weight_bits={weight_bits}")
    policy = policy or QuantPolicy()
    ctx = QuantContext(policy=policy, calibrations=dict(calibrations or {}),
                       impl=impl)
    device = torch.device(device)

    def walk(node, path):
        if _is_linear_node(node):
            site = "/".join(path)
            out = _to_device(dict(node), device)
            if policy.mode != QuantMode.NONE and policy.should_quantize(
                    site, ctx.lookup(site)):
                out["w"] = quantize_weight(out["w"])
            return out
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        return _to_device(node, device)

    return walk(params, ()), ctx
