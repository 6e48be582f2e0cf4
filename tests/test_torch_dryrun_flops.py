"""The dry run's counted train FLOPs against a count by hand from the
shapes: Llama-3.2-3B (dense), Mixtral-8x22B (MoE, dropless) and
Zamba2-1.2B (Mamba2 with the shared attention block), each at its full
width, at a reduced depth and at a small batch (B 1 x S 256), one rank of
a (1, 1) mesh, full remat.

The count by hand, for the products ``FlopCounterMode`` counts (matrix
products; the elementwise work -- norms, the causal conv, softmax -- is
not counted):

* forward: every projection 2·T·d_in·d_out; attention (``_sdpa`` under
  autograd, the whole S x S score block) 4·B·Hq·S²·hd; the experts 3
  products of 2·d·ff over T·k assignments (the balanced split holds all of
  them, as dropless routing does) and the router 2·T·d·E; Mamba2's chunk
  scan, one chunk of L = S here: scores and the intra-chunk product
  2·B·H·L²·dk and 2·B·H·L²·dv, the state read and the state update
  2·B·L·H·dk·dv each; the logits 2·T·d·V;
* backward: twice the forward of each product, except the two that meet
  the zero initial state or leave a final state nothing reads (the state
  read's gradient goes to q only, the state update has none);
* full remat: each layer's forward again, up to the last product whose
  inputs its backward keeps (the non-reentrant checkpoint stops there):
  a dense or Mamba2 layer's last product is not recomputed, an MoE
  layer's is (its combine keeps the expert outputs).

The ratio to ``costmodel.model_flops_train`` times the remat factor 4/3
is printed: the attention's S² work and the remat's stop are what it
leaves out.
"""
import pytest

from repro_torch import configs
from repro_torch.config import ParallelConfig, ShapeConfig
from repro_torch.core import costmodel
from repro_torch.core.mesh import RecordingMesh
from repro_torch.launch import dryrun

B, S = 1, 256
T = B * S


def _attn(cfg) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {"q": 2 * T * d * cfg.n_heads * hd, "k": 2 * T * d * cfg.n_kv_heads * hd,
            "v": 2 * T * d * cfg.n_kv_heads * hd, "o": 2 * T * cfg.n_heads * hd * d,
            "sdpa": 4 * B * cfg.n_heads * S * S * hd}


def _mlp(cfg, ff) -> dict:
    return {"gate": 2 * T * cfg.d_model * ff, "up": 2 * T * cfg.d_model * ff,
            "down": 2 * T * ff * cfg.d_model}


def _train(layers, cfg) -> float:
    """3x the forward (the backward's two products per product), less the
    backward products that do not run, plus each layer's recompute.
    ``layers``: (forward products by name, names without a backward
    product per operand, names not recomputed)."""
    logits = 2 * T * cfg.d_model * cfg.vocab
    total = 3 * logits
    for fwd, half, tail in layers:
        for name, f in fwd.items():
            total += f + 2 * f - {"none": 2 * f, "one": f}.get(half.get(name), 0)
            total += 0 if name in tail else f
    return total


def _hand(arch: str, cfg) -> float:
    if arch == "llama3.2-3b":
        layer = {**_attn(cfg), **_mlp(cfg, cfg.d_ff)}
        return _train([(layer, {}, {"down"})] * cfg.n_layers, cfg)
    if arch == "mixtral-8x22b":
        e = cfg.moe
        layer = {**_attn(cfg), "router": 2 * T * cfg.d_model * e.n_experts,
                 "experts": 3 * 2 * T * e.top_k * cfg.d_model * e.d_ff_expert}
        return _train([(layer, {}, set())] * cfg.n_layers, cfg)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh, dk, dv = d_in // s.head_dim, s.d_state, s.head_dim
    mamba = {"in_proj": 2 * T * cfg.d_model * (2 * d_in + 2 * dk + nh),
             "scores": 2 * B * nh * S * S * dk, "intra": 2 * B * nh * S * S * dv,
             "state_read": 2 * B * S * nh * dk * dv, "state_update": 2 * B * S * nh * dk * dv,
             "out_proj": 2 * T * d_in * cfg.d_model}
    half = {"state_read": "one", "state_update": "none"}
    shared = {**{f"a_{k}": v for k, v in _attn(cfg).items()},
              **{f"m_{k}": v for k, v in _mlp(cfg, cfg.d_ff).items()}}
    layers = [({**mamba, **shared}, half, {"m_down"}) if kind == "mamba2_attn"
              else (mamba, half, {"out_proj"})
              for kind in (cfg.block_pattern * cfg.n_periods)]
    return _train(layers, cfg)


@pytest.mark.parametrize("arch,layers", [("llama3.2-3b", 2), ("mixtral-8x22b", 1),
                                         ("zamba2-1.2b", 19)])
def test_train_flops_match_hand_count(arch, layers):
    cfg = configs.get(arch).replace(n_layers=layers)
    assert S <= (cfg.ssm.chunk if cfg.ssm else S)
    raw = dryrun.trace_cell(arch, ShapeConfig("hand", "train", S, B),
                            RecordingMesh((1, 1), ("data", "model")),
                            pcfg=ParallelConfig(remat="full", fsdp_params=False),
                            cfg_override=cfg)
    hand = _hand(arch, cfg)
    model = costmodel.model_flops_train(cfg.param_counts()["active"], T) * 4 / 3
    print(f"{arch} ({layers} layers, B {B} x S {S}): counted {raw['flops']:.6e}, by hand "
          f"{hand:.6e} (ratio {raw['flops'] / hand:.6f}), model_flops_train x 4/3 "
          f"{model:.6e} (counted / that {raw['flops'] / model:.4f})")
    assert raw["flops"] == pytest.approx(hand, rel=1e-2)
    assert raw["kernel_flops"] == 0 and raw["collectives"]["wire_bytes"] == 0
