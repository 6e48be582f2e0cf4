"""The work of single layers, counted from the shapes and from the
program's span attributes: FLOPs and bytes, as ``counts.py`` counts them
(each input read once and each output written once, in the served dtype),
for the layers whose count depends on the layer.

  * ``windows``: each layer's attention window, from the configuration
    file's ``layer_windows`` (tiled over the layers like ``block_pattern``;
    None is full attention), or without the key its one ``window`` (None
    if it has none) in every layer;
  * ``paged_decode_bytes``: the split-KV decode's bytes with each layer's
    own window: a window layer reads min(length, window) K/V slots of its
    ring, a full layer the row's length;
  * ``flash_prefill``: the flash kernel's FLOPs and bytes over every layer
    for one unpadded prompt, each layer's causal pairs cut to its window;
  * ``expert_flops``, ``expert_bytes``: the grouped SwiGLU products of one
    MoE layer call, from its ``moe.experts`` span (``experts`` given a row,
    ``rows`` assignments).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from bench.counts import BYTES, _hd, _kinds, causal_pairs


def windows(model: dict) -> List[Optional[int]]:
    """The attention window of every layer (None: full attention)."""
    per = model.get("layer_windows")
    n = len(_kinds(model))
    return [model.get("window")] * n if per is None else [per[i % len(per)] for i in range(n)]


def paged_decode_bytes(model: dict, lengths: Iterable[int]) -> int:
    """Bytes the split and combine kernels must move over every layer for
    one decode step of rows holding ``lengths`` tokens (the new one
    included): each row's K and V once up to its length, or the layer's
    window, its q read and its output written."""
    hq, hkv, hd = model["n_heads"], model["n_kv_heads"], _hd(model)
    lengths = list(lengths)
    total = 0
    for w in windows(model):
        slots = sum(lengths) if w is None else sum(min(n, w) for n in lengths)
        total += (slots * 2 * hkv * hd + len(lengths) * 2 * hq * hd) * BYTES
    return total


def flash_prefill(model: dict, length: int) -> tuple:
    """(FLOPs, bytes) of the flash kernel over every layer for one unpadded
    prompt of ``length`` tokens: 4 * hd * Hq FLOPs for each pair its layer's
    window leaves visible; q, k, v read once and the output written once
    in every layer."""
    hq, hkv, hd = model["n_heads"], model["n_kv_heads"], _hd(model)
    flops = sum(4 * hd * hq * causal_pairs(length, w) for w in windows(model))
    nbytes = len(_kinds(model)) * length * hd * (2 * hq + 2 * hkv) * BYTES
    return flops, nbytes


def expert_flops(model: dict, rows: int) -> int:
    """The gate, up and down products of ``rows`` assignments: 2 * 3 * d *
    ff FLOPs each."""
    return 2 * 3 * model["d_model"] * model["moe"]["d_ff_expert"] * rows


def expert_bytes(model: dict, experts: int, rows: int) -> int:
    """Each expert given a row reads its three d x ff matrices once; the
    rows go in and come out (d wide each)."""
    d, ff = model["d_model"], model["moe"]["d_ff_expert"]
    return (experts * 3 * d * ff + 2 * rows * d) * BYTES
