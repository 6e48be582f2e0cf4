"""The work the inputs need, counted from the shapes: FLOPs and bytes.

A token's matrix work is 2 FLOPs for each matrix parameter it touches:
in every layer the attention projections and either the dense MLP or the
MoE router and ``top_k`` experts, and the output head where logits are
taken (every decode token; a prompt's last token only).  Attention adds
4·hd·Hq FLOPs for each (query, key) pair the mask leaves visible (Q·Kᵀ and
P·V).  Norms, RoPE, softmax and the embedding lookup are not counted.
Bytes are what a kernel must move at least: each input read once and each
output written once, in the served dtype (2 bytes).
"""
from __future__ import annotations

from typing import Iterable

BYTES = 2   # bf16 activations and K/V


def _hd(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def _kinds(model: dict):
    pattern = model.get("block_pattern", ["attn"])
    return [pattern[i % len(pattern)] for i in range(model["n_layers"])]


def layer_params(model: dict) -> int:
    """Matrix parameters a token touches in all the layers (no head)."""
    d, hq, hkv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], _hd(model)
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    total = 0
    for kind in _kinds(model):
        if kind == "attn":
            total += attn + 3 * d * model["d_ff"]
        elif kind == "attn_moe":
            moe = model["moe"]
            total += attn + d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
        else:
            raise NotImplementedError(f"no count for layer kind {kind!r}")
    return total


def head_params(model: dict) -> int:
    return model["d_model"] * model["vocab"]


def causal_pairs(length: int, window=None) -> int:
    """Visible (query, key) pairs of a causal prompt of ``length`` tokens."""
    if window is None or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def attn_flops_per_pair(model: dict) -> int:
    """Attention FLOPs of one visible pair over all the layers."""
    return 4 * _hd(model) * model["n_heads"] * len(_kinds(model))


def prefill_flops(model: dict, length: int) -> int:
    """A prompt of ``length`` tokens from position 0, logits at its last."""
    return (2 * length * layer_params(model) + 2 * head_params(model)
            + attn_flops_per_pair(model) * causal_pairs(length, model.get("window")))


def decode_flops(model: dict, pos: int) -> int:
    """One decode token at position ``pos`` (it sees ``pos + 1`` keys)."""
    keys = pos + 1 if model.get("window") is None else min(pos + 1, model["window"])
    return 2 * (layer_params(model) + head_params(model)) + attn_flops_per_pair(model) * keys


def flash_prefill(model: dict, length: int) -> tuple:
    """(FLOPs, bytes) of the flash kernel over every layer for one unpadded
    prompt: q, k, v read once and the output written once."""
    hq, hkv, hd = model["n_heads"], model["n_kv_heads"], _hd(model)
    layers = len(_kinds(model))
    flops = attn_flops_per_pair(model) * causal_pairs(length, model.get("window"))
    nbytes = layers * length * hd * (2 * hq + 2 * hkv) * BYTES
    return flops, nbytes


def paged_decode_bytes(model: dict, lengths: Iterable[int]) -> int:
    """Bytes the paged kernel must move over every layer for one decode
    step of rows holding ``lengths`` tokens (the new one included): each
    row's K and V once, its q read and its output written."""
    hq, hkv, hd = model["n_heads"], model["n_kv_heads"], _hd(model)
    lengths = list(lengths)
    per_layer = (sum(lengths) * 2 * hkv * hd + len(lengths) * 2 * hq * hd) * BYTES
    return per_layer * len(_kinds(model))
