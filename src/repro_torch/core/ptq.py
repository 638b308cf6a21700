"""Post-training quantization: FP32/bf16 model → INT8 model (paper §4).

Port of ``repro/core/ptq.py``:

    calibrations = Calibrator(fwd).run(batches).compute(mode="symmetric")
    qparams, qctx = quantize_model(params, calibrations, policy)
    logits = model.forward(qparams, batch, quant=qctx)

``quantize_model`` walks the parameter tree, finds linear nodes (dicts with
a ``"w"`` leaf of rank ≥ 2), and replaces approved weights with
per-output-channel symmetric :class:`QTensor`; with ``weight_bits=4`` the
decoder FFN and attention output projections become block-wise INT4
:class:`BlockQTensor` instead.  ``QuantContext`` is the
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
from repro_torch.core.qtensor import (
    BlockQTensor,
    QTensor,
    div_exact,
    quantize_block,
    rdiv_exact,
)
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

    def quantize_activations(self, site: str) -> bool:
        if not self.enabled or self.policy.mode == QuantMode.NONE:
            return False
        return self.policy.should_quantize(site, self.lookup(site))

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


def quantize_weight_block(w: torch.Tensor, group_size: int = 128,
                          scale_dtype: torch.dtype = torch.float16
                          ) -> BlockQTensor:
    """Block-wise INT4 weight quantization (group scale/min along d_in)."""
    return quantize_block(w, group_size=group_size, scale_dtype=scale_dtype)


# Which sites may drop to INT4 (the paper's sensitivity result): decoder FFN
# and attention *output* projections only.  q/k/v projections feed the
# attention score path and the KV cache; those, all encoder weights, the
# logits head and every activation stay INT8/FP.
_INT4_FFN_LEAVES = ("in", "out", "gate", "up", "down")


def int4_eligible_site(site: str) -> bool:
    parts = site.split("/")
    if not any(p == "dec_blocks" or p.startswith("dec_blocks.")
               for p in parts):
        return False
    if parts[-1] == "o_proj":
        return True
    return (len(parts) >= 2 and parts[-2] == "ffn"
            and parts[-1] in _INT4_FFN_LEAVES)


def _to_device(node: Any, device: torch.device) -> Any:
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    move = lambda p: p.to(device) if isinstance(p, torch.Tensor) else p
    if isinstance(node, QTensor):
        return QTensor(move(node.data), move(node.scale),
                       move(node.zero_point), node.axis)
    if isinstance(node, BlockQTensor):
        return BlockQTensor(move(node.data), move(node.scale),
                            move(node.vmin), node.group_size, node.k_dim)
    return move(node)


def quantize_model(
    params: Dict[str, Any],
    calibrations: Optional[Dict[str, SiteCalibration]] = None,
    policy: Optional[QuantPolicy] = None,
    impl: str = "auto",
    *,
    weight_bits: int = 8,
    weight_group_size: int = 128,
    weight_scale_dtype: torch.dtype = torch.float16,
    device: str = "cuda",
) -> Tuple[Dict[str, Any], QuantContext]:
    """PTQ transform: returns (quantized params on ``device``, QuantContext).

    ``weight_bits=4`` drops the INT4-eligible weights (decoder FFN and
    attention output projections, :func:`int4_eligible_site`) to block-wise
    INT4 with ``weight_group_size`` rows per scale/min block; every other
    approved site keeps the paper's per-channel INT8.
    """
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
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
                if weight_bits == 4 and int4_eligible_site(site):
                    out["w"] = quantize_weight_block(
                        out["w"], group_size=weight_group_size,
                        scale_dtype=weight_scale_dtype)
                else:
                    out["w"] = quantize_weight(out["w"])
            return out
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        return _to_device(node, device)

    return walk(params, ()), ctx


def count_quantized(params: Dict[str, Any]) -> Dict[str, int]:
    """Linears and bytes by precision, as the reference counts them."""
    stats = {"quantized_linears": 0, "fp_linears": 0, "int8_bytes": 0,
             "fp_bytes": 0, "int4_linears": 0, "int4_bytes": 0}

    def walk(node):
        if isinstance(node, QTensor):
            stats["quantized_linears"] += 1
            stats["int8_bytes"] += node.nbytes()
        elif isinstance(node, BlockQTensor):
            stats["quantized_linears"] += 1
            stats["int4_linears"] += 1
            stats["int4_bytes"] += node.nbytes()
        elif isinstance(node, dict):
            if _is_linear_node(node):
                stats["fp_linears"] += 1
            for v in node.values():
                walk(v)
        elif isinstance(node, torch.Tensor):
            stats["fp_bytes"] += node.numel() * node.element_size()

    walk(params)
    return stats


def weight_bytes_by_site(params: Dict[str, Any]) -> Dict[str, int]:
    """Per-site weight footprint (bytes streamed per decode step): payload
    plus scale metadata for quantized weights, raw bytes for FP linears."""
    out: Dict[str, int] = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "w" in node and (_is_linear_node(node) or isinstance(
                    node["w"], (QTensor, BlockQTensor))):
                w = node["w"]
                out["/".join(path)] = (w.nbytes() if isinstance(
                    w, (QTensor, BlockQTensor))
                    else w.numel() * w.element_size())
                return
            for k, v in node.items():
                walk(v, path + (str(k),))

    walk(params, ())
    return out
