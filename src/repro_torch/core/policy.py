"""Selective-quantization policy (paper §4.2: "sparse tensors stay FP32").

A policy decides, per matmul site, whether the quantized path is used.  The
decision combines:

* the calibration classification (``sparse`` histograms opt out — the paper
  left 12 of 97 MatMuls in FP32),
* explicit deny-list patterns for numerically sensitive sites the paper's §3
  rules out of INT8 entirely (softmax, layer-norm) plus framework additions
  (MoE router logits, final logits head by default),
* a global mode switch.

Port of ``repro/core/policy.py`` (pure Python, unchanged).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Optional, Sequence

from repro_torch.core.calibration import SiteCalibration
from repro_torch.core.quantize import QuantMode

# Sites never quantized regardless of calibration — the paper's "keep
# softmax / norm / division in FP32" rule extended to the model zoo.
DEFAULT_DENY: tuple = (
    "*router*",        # MoE routing logits feed a softmax/top-k
    "*gate_ssm*",      # SSM gates/recurrence
    "*logits*",        # final LM head (configurable; BLEU-sensitive)
)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    mode: QuantMode = QuantMode.SYMMETRIC
    skip_sparse: bool = True
    deny: Sequence[str] = DEFAULT_DENY
    allow_only: Optional[Sequence[str]] = None   # if set, whitelist mode
    act_quant: str = "static"                    # "static" (calibrated) | "dynamic"
    quantize_kv_cache: bool = True               # paper §5.3 analogue
    # static-mode fallback threshold for uncalibrated sites (paper §5.5:
    # thresholds are trace-time constants — no runtime Min/Max scan, and
    # under SPMD no cross-shard amax reduction on TP-sharded activations)
    default_amax: Optional[float] = None

    def denies(self, site: str) -> bool:
        return any(fnmatch.fnmatch(site, pat) for pat in self.deny)

    def allows(self, site: str) -> bool:
        if self.allow_only is not None:
            return any(fnmatch.fnmatch(site, pat) for pat in self.allow_only)
        return True

    def should_quantize(
        self, site: str, calib: Optional[SiteCalibration] = None
    ) -> bool:
        if self.mode == QuantMode.NONE:
            return False
        if self.denies(site) or not self.allows(site):
            return False
        if calib is not None:
            if self.skip_sparse and calib.classification.kind == "sparse":
                return False
            return calib.quantize
        # No calibration record: static mode cannot quantize activations
        # blindly, dynamic mode can.
        return self.act_quant == "dynamic" or self.mode == QuantMode.NAIVE


def summarize(policy: QuantPolicy,
              calibrations: Dict[str, SiteCalibration]) -> Dict[str, int]:
    """Counts mirroring the paper's '12 of 97 MatMuls stayed FP32'."""
    stats = {"total": 0, "quantized": 0, "sparse_skipped": 0, "denied": 0}
    for site, calib in calibrations.items():
        stats["total"] += 1
        if policy.denies(site) or not policy.allows(site):
            stats["denied"] += 1
        elif policy.skip_sparse and calib.classification.kind == "sparse":
            stats["sparse_skipped"] += 1
        elif policy.should_quantize(site, calib):
            stats["quantized"] += 1
    return stats
