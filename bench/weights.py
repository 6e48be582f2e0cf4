"""The served model's weights, made on the device from the run's seed.

The leaves are those of the configuration's ``leaf_plan``: its model
module's (``spec.model_module``), or ``leaf_plan`` below for the attention
layers of ``bench/reference.py``.  The tree has the port's parameter layout
(``params["embed"]``, ``params["layers"][i]``, ``params["final_norm"]``),
with the dtypes the port serves in: every matrix in the served dtype
(bf16), the norm scales and the MoE router in f32.  The same tensors go to
the program and to the reference; neither side derives anything from the
other's.

The draws are a few large calls of one ``torch.Generator`` on the device:
one flat buffer of the served dtype holds every matrix and one f32 buffer
every vector and router, each filled with N(0, 1) in slices of at most
``SLICE`` elements; each leaf is then a view of its buffer, scaled in place
to its standard deviation (1/sqrt(d_in) for a matrix, 0.02 for the
embedding, as the port's own init draws them).  The norm scales are
1 + 0.1 z, so that a scale that is skipped or misapplied shows in the
logits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

SLICE = 1 << 30          # elements per RNG call
ALIGN = 128              # every leaf starts at a multiple of 128 elements
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def kind_of(model: dict, i: int) -> str:
    pattern = model.get("block_pattern", ["attn"])
    return pattern[i % len(pattern)]


def leaf_plan(model: dict) -> List[Tuple[tuple, tuple, str, float]]:
    """Every leaf as (path, shape, "matrix" | "vector", std); a vector of
    std 0 is a norm scale (1 + 0.1 z)."""
    d, hq, hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // hq
    vocab = model["vocab"]
    plan = [(("embed", "embedding"), (vocab, d), "matrix", 0.02),
            (("embed", "unembed"), (d, vocab), "matrix", 1 / math.sqrt(d))]
    for i in range(model["n_layers"]):
        kind = kind_of(model, i)
        if kind not in ("attn", "attn_moe"):
            raise NotImplementedError(f"the benchmark makes weights for attention layers only, "
                                      f"not {kind!r}")
        lp = ("layers", i)
        plan += [(lp + ("ln1", "scale"), (d,), "vector", 0.0),
                 (lp + ("attn", "wq"), (d, hq * hd), "matrix", 1 / math.sqrt(d)),
                 (lp + ("attn", "wk"), (d, hkv * hd), "matrix", 1 / math.sqrt(d)),
                 (lp + ("attn", "wv"), (d, hkv * hd), "matrix", 1 / math.sqrt(d)),
                 (lp + ("attn", "wo"), (hq * hd, d), "matrix", 1 / math.sqrt(hq * hd)),
                 (lp + ("ln2", "scale"), (d,), "vector", 0.0)]
        if kind == "attn":
            ff = model["d_ff"]
            plan += [(lp + ("mlp", "w_gate"), (d, ff), "matrix", 1 / math.sqrt(d)),
                     (lp + ("mlp", "w_up"), (d, ff), "matrix", 1 / math.sqrt(d)),
                     (lp + ("mlp", "w_down"), (ff, d), "matrix", 1 / math.sqrt(ff))]
        else:
            moe = model["moe"]
            e, ff = moe["n_experts"], moe["d_ff_expert"]
            plan += [(lp + ("moe", "router"), (d, e), "vector", 1 / math.sqrt(d)),
                     (lp + ("moe", "w_gate"), (e, d, ff), "matrix", 1 / math.sqrt(d)),
                     (lp + ("moe", "w_up"), (e, d, ff), "matrix", 1 / math.sqrt(d)),
                     (lp + ("moe", "w_down"), (e, ff, d), "matrix", 1 / math.sqrt(ff))]
    plan.append((("final_norm", "scale"), (d,), "vector", 0.0))
    return plan


def _fill(buf: torch.Tensor, gen: torch.Generator) -> None:
    flat = buf.view(-1)
    for lo in range(0, flat.numel(), SLICE):
        flat[lo:lo + SLICE].normal_(generator=gen)


def make(model: dict, seed: int, device, plan: Optional[List] = None) -> Dict:
    """The parameter tree of ``model`` (a configuration file's ``model``
    block) for ``seed``, on ``device``, with the leaves of ``plan``
    (``leaf_plan(model)`` by default)."""
    plan = leaf_plan(model) if plan is None else plan
    dtype = _DTYPES[model.get("dtype", "bfloat16")]
    sizes = {"matrix": 0, "vector": 0}
    offsets = []
    for _, shape, kind, _ in plan:
        offsets.append(sizes[kind])
        sizes[kind] += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bufs = {"matrix": torch.empty(sizes["matrix"], dtype=dtype, device=device),
            "vector": torch.empty(sizes["vector"], dtype=torch.float32, device=device)}
    for buf in bufs.values():
        _fill(buf, gen)
    params: Dict = {"layers": [{} for _ in range(model["n_layers"])]}
    for (path, shape, kind, std), off in zip(plan, offsets):
        leaf = bufs[kind][off:off + math.prod(shape)].view(shape)
        if std == 0.0:
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(std)
        node = params
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = leaf
    return params
