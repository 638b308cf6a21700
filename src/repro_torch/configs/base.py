"""Model configuration + registry (port of ``repro/configs/base.py``).

Only what the ported families read is kept (the encoder-decoder
translation model and the decoder-only MoE model); the field names and
defaults are the reference's, so a configuration reads the same in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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
class ModelConfig:
    name: str
    family: str                     # audio (enc-dec) | moe | dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    ffn: str = "swiglu"             # dense FFN: the port has gelu only
    rope_theta: float = 10000.0
    max_seq: int = 32768
    tie_embeddings: bool = False
    attn_bias: bool = False
    moe: Optional[MoEConfig] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    input_kind: str = "tokens"
    # the reference's scan_layers/remat switches have no counterpart: the
    # port runs its layers in an eager loop over unstacked parameters
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

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
        )
        if self.moe:
            small["moe"] = MoEConfig(n_experts=4, top_k=2, group_size=32)
        if self.enc_dec:
            small["n_enc_layers"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


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

