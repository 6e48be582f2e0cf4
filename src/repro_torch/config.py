"""Model architecture configs as plain frozen dataclasses.

The port's copy of ``ModelConfig`` and the family configs it names. The
fields, defaults and derived properties are those of the JAX package's
config, so one arch reads the same in both; dtype names stay strings and
``torch_dtype`` maps them to torch dtypes.  ``ShapeConfig`` / ``SHAPES``
(input shapes), ``ParallelConfig`` (layout and numerics of a train step) and
``TrainConfig`` (optimizer, schedule, checkpoints) are the reference's, field
for field and default for default.

Two fields are the port's own, both None for every arch the reference
names: ``layer_windows``, an attention window a layer (tiled over the
layers as ``block_pattern`` is; None is full attention), where
``window`` is one window for every layer; and ``yarn``, the YaRN RoPE of
the full-attention layers.  ``layer_config(i)`` is the config that layer
``i`` runs under: its own window as ``window`` and, on a full layer, the
YaRN RoPE.
"""
from __future__ import annotations

import dataclasses
import functools
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
class YarnConfig:
    """YaRN's rescaled RoPE (HF ``rope_type: yarn``): a rotary pair that
    turns fewer than ``beta_slow`` times over the
    ``original_max_position_embeddings`` positions has its frequency
    divided by ``factor``, one that turns more than ``beta_fast`` times
    keeps it, and the pairs between blend the two on a linear ramp; cos and
    sin are scaled by ``attention_factor`` (``layers.yarn_inv_freq``)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    attention_factor: float


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
    # a window a layer, tiled like block_pattern (None: full attention)
    layer_windows: Optional[Tuple[Optional[int], ...]] = None
    yarn: Optional[YarnConfig] = None        # RoPE of the full-attention layers
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
    param_dtype: str = "float32"             # master params
    sub_quadratic: bool = False
    notes: str = ""

    def __post_init__(self):
        # a configuration file gives lists and a dict: kept as a tuple and a
        # YarnConfig, so that the frozen config stays hashable
        if self.layer_windows is not None:
            if self.window is not None:
                raise ValueError(f"{self.name}: set window or layer_windows, not both")
            object.__setattr__(self, "layer_windows", tuple(self.layer_windows))
        if isinstance(self.yarn, dict):
            object.__setattr__(self, "yarn", YarnConfig(**self.yarn))
        if self.yarn is not None and self.window is not None:
            raise ValueError(f"{self.name}: yarn is the RoPE of full-attention layers; a "
                             f"model-wide window leaves none")

    def layer_config(self, i: int) -> "ModelConfig":
        """The config layer ``i`` runs under: this one, or with per-layer
        windows the layer's window as ``window`` and ``yarn`` on a full
        layer only."""
        if self.layer_windows is None:
            return self
        return self._layer_configs[i % len(self.layer_windows)]

    @functools.cached_property
    def _layer_configs(self) -> Tuple["ModelConfig", ...]:
        return tuple(self.replace(layer_windows=None, window=w,
                                  yarn=self.yarn if w is None else None)
                     for w in self.layer_windows)

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

    # ---- parameter counting (drives MODEL_FLOPS and memory estimates) ----
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.hd
        counts: dict = {}
        counts["embed"] = self.vocab * d
        counts["unembed"] = 0 if self.tie_embeddings else self.vocab * d
        per_kind = {}
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        mlp_mult = 3 if self.act == "swiglu" else 2
        per_kind["attn"] = attn + mlp_mult * d * self.d_ff + 2 * d
        if self.moe:
            e = self.moe
            experts = e.n_experts * mlp_mult * d * e.d_ff_expert
            shared = e.n_shared_experts * mlp_mult * d * e.d_ff_expert
            router = d * e.n_experts
            per_kind["attn_moe"] = attn + experts + shared + router + 2 * d
        if self.ssm:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_kind["mamba2"] = (d * (2 * d_in + 2 * s.d_state + nh)
                                  + s.conv_width * (d_in + 2 * s.d_state)
                                  + 2 * nh + d_in * d + 2 * d)
            per_kind["mamba2_attn"] = per_kind["mamba2"]  # shared attn counted once below
        if self.xlstm:
            f = self.xlstm
            d_in = int(f.proj_factor * d)
            per_kind["mlstm"] = d * 2 * d_in + 3 * d_in * d_in // 1 + d_in * d + 2 * d
            per_kind["slstm"] = 4 * 2 * d * d + d * d + 2 * d
        total = counts["embed"] + counts["unembed"]
        for kind in self.block_pattern:
            base = kind if kind in per_kind else "attn"
            total += per_kind[base] * self.n_periods
        if "mamba2_attn" in self.block_pattern:
            total += attn + mlp_mult * d * self.d_ff  # one shared block
        counts["total"] = total
        # active (MoE: only top_k + shared experts per token)
        active = total
        if self.moe:
            e = self.moe
            dead = (e.n_experts - e.top_k) * mlp_mult * d * e.d_ff_expert
            active = total - dead * self.block_pattern.count("attn_moe") * self.n_periods
        counts["active"] = active
        return counts


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How the model is laid out on the mesh."""
    fsdp_params: bool = True        # shard params over 'data' (ZeRO-3 style)
    fsdp_pod: bool = False          # extend param/opt sharding over 'pod'
    grad_reduce: Literal["all_reduce", "reduce_scatter_zero"] = "all_reduce"
    # ^ reduce_scatter_zero: grads reduce-scattered over the fsdp/data axes,
    #   AdamW updates only the local shard, params all-gathered (ZeRO)
    opt_state_dtype: str = "float32"   # float32|bfloat16 (compression)
    grad_dtype: str = "bfloat16"       # gradient all-reduce compression
    remat: Literal["none", "dots", "full"] = "full"
    sequence_parallel: bool = False
    use_flash_kernel: bool = False  # Pallas attention inside shard_map
    use_foopar_tp: bool = False     # algebra-based TP matmuls (paper-faithful)
    logit_chunk: Optional[int] = None  # chunked CE loss over sequence
    scan_unroll: int = 1            # layer-scan unroll (dry-run flop probing)
    moe_a2a_ep: bool = False        # token-routing EP (tokens move, not weights)
    engine_replicate: bool = False  # SSM/mLSTM engine: batch-shard only (§Perf)
    master_weights: bool = False    # bf16 params + f32 master in opt (§Perf)
    grad_barrier: bool = False      # optimization_barrier on grads (§Perf)
    manual_attention: bool = False  # manual shard_map SDPA region (§Perf)
    dp_over_model: bool = False     # pure DP: batch over BOTH axes (§Perf C7)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
