"""Model architecture configs as plain frozen dataclasses.

The port's copy of ``ModelConfig`` and the family configs it names. The
fields, defaults and derived properties are those of the JAX package's
config, so one arch reads the same in both; dtype names stay strings and
``torch_dtype`` maps them to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` -> the torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0      # dense experts always active (Kimi-style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2                # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length
    unroll: int = 1
    mm_bf16: bool = False


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8           # one sLSTM block per this many layers
    proj_factor: float = 2.0       # mLSTM up-projection
    chunk: int = 256
    unroll: int = 1
    mm_bf16: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # block structure: period of layer kinds, tiled to n_layers
    block_pattern: Tuple[str, ...] = ("attn",)   # attn|mamba2|mamba2_attn|mlstm|slstm
    # attention details
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0               # chatglm 2d-RoPE = 0.5
    window: Optional[int] = None             # sliding-window attention
    qk_norm: bool = False                    # chameleon
    parallel_block: bool = False             # command-r style attn ∥ mlp
    # norms / act
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "gelu"] = "swiglu"
    norm_eps: float = 1e-5
    # families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    enc_dec: bool = False                    # whisper
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    # numerics
    dtype: str = "bfloat16"                  # activation/compute dtype
    param_dtype: str = "float32"             # master params (JAX side)
    sub_quadratic: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> Tuple[str, ...]:
        return self.block_pattern

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a "
                             f"multiple of the pattern {self.block_pattern}")
        return self.n_layers // len(self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
