"""Model configuration, the architecture registry and the shape cells
(port of ``repro/configs/base.py``).

Every assigned architecture registers a :class:`ModelConfig` (one file per
arch under ``repro_torch/configs/``), selectable with ``--arch <id>`` in the
launchers.  The field names, defaults and derived counts are the
reference's, so a configuration reads the same in both packages; the
reference's ``scan_layers`` switch has no counterpart, since the port runs
its layers in an eager loop over unstacked parameters.  ``remat`` has the
reference's meaning and default: each block of a training forward is
recomputed in the backward (``distributed.context.run_layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 1024          # GShard-style dispatch group


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 64                 # N — SSM state size
    conv_width: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    head_dim: int = 64              # P — channels per SSM head
    chunk: int = 256                # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6             # shared attention block cadence (zamba2)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8            # 1-in-8 blocks are sLSTM (xLSTM [7:1])
    chunk: int = 256                # mLSTM chunked-parallel length


@dataclasses.dataclass(frozen=True)
class QuantSettings:
    """Arch-level defaults for the paper's technique (overridable via CLI)."""

    mode: str = "symmetric"         # none|naive|symmetric|independent|conjugate
    act_quant: str = "dynamic"      # static (calibrated) | dynamic
    quantize_kv_cache: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    ffn: str = "swiglu"             # swiglu | gelu | none
    rope_theta: float = 10000.0
    max_seq: int = 32768
    tie_embeddings: bool = False
    attn_bias: bool = False
    logits_softcap: Optional[float] = None

    # family-specific
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    input_kind: str = "tokens"      # tokens | embeddings (vlm/audio stubs)

    # execution (the reference's scan_layers has no counterpart)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    quant: QuantSettings = QuantSettings()

    @property
    def hd(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding included), by the reference's
        formula: it counts an untied embedding twice, and approximates the
        ssm and hybrid families."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = (d * (self.n_heads + 2 * self.n_kv_heads) * hd
                + self.n_heads * hd * d)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm"):
            if self.moe:
                ffn = (self.moe.n_experts * 3 * d * self.d_ff
                       + d * self.moe.n_experts)
            else:
                ffn = (3 * d * self.d_ff if self.ffn == "swiglu"
                       else 2 * d * self.d_ff)
            per_layer = attn + ffn
        elif self.family == "ssm":  # xlstm
            d_in = d * 2
            per_layer = d * d_in * 4 + d_in * d  # qkv+gates up/down approx
        elif self.family == "hybrid":
            s = self.ssm or SSMConfig()
            d_inner = s.expand * d
            mamba = (d * (2 * d_inner + 2 * s.state + d_inner // s.head_dim)
                     + d_inner * d)
            n_attn = self.n_layers // (self.hybrid.attn_every
                                       if self.hybrid else 6)
            per_layer = mamba + (attn + 2 * d * self.d_ff) * max(
                n_attn, 1) / max(self.n_layers, 1)
        elif self.family == "audio":
            # the decoder has self- and cross-attention
            per_layer = 2 * attn + 2 * d * self.d_ff
        total = emb + (self.n_layers + self.n_enc_layers) * per_layer
        return int(total)

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params
        d = self.d_model
        dense_ffn = self.moe.n_experts * 3 * d * self.d_ff
        active_ffn = self.moe.top_k * 3 * d * self.d_ff
        return int(self.n_params - self.n_layers * (dense_ffn - active_ffn))

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test configuration of the same family (CPU-runnable)."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128 if self.d_ff else 0,
            vocab=128,
            head_dim=16,
            max_seq=128,
            dtype="float32",
            remat=False,
        )
        if self.moe:
            small["moe"] = MoEConfig(n_experts=4, top_k=2, group_size=32)
        if self.ssm:
            small["ssm"] = SSMConfig(state=8, head_dim=8, expand=2, chunk=16)
        if self.hybrid:
            small["hybrid"] = HybridConfig(attn_every=2)
        if self.xlstm:
            small["xlstm"] = XLSTMConfig(slstm_every=2, chunk=16)
        if self.enc_dec:
            small["n_enc_layers"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Families with a sub-quadratic sequence path (may run long_500k).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig) -> List[Tuple[ShapeConfig, Optional[str]]]:
    """All four assigned shapes with a skip reason where applicable."""
    out = []
    for shape in SHAPES.values():
        skip = None
        if (shape.name == "long_500k"
                and cfg.family not in SUBQUADRATIC_FAMILIES):
            skip = ("pure full-attention arch: no sub-quadratic path at 524k "
                    "context (skip noted in DESIGN.md §Arch-applicability)")
        out.append((shape, skip))
    return out


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (runs the registrations)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()



def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
