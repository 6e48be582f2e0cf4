"""The FLOP and byte counts: against hand counts at small shapes, and the
prefill count against the dry run's rule (``FlopCounterMode`` plus the
flash kernel's meta tally, as ``launch/dryrun.py`` counts) on ``meta``
tensors for a reduced dense and MoE configuration."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_tiny
from bench import counts, harness


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


def test_hand_counts_dense():
    m = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab": 10, "block_pattern": ["attn"]}
    # attention 8*8 + 2*8*4 + 8*8 = 192, MLP 3*8*16 = 384, per layer 576
    assert counts.layer_params(m) == 2 * 576
    assert counts.head_params(m) == 80
    assert counts.causal_pairs(4) == 10
    assert counts.causal_pairs(5, window=2) == 3 + 3 * 2
    # 3 tokens: 2*3*1152 + 2*80 + 4*4*2 heads*2 layers * 6 pairs
    assert counts.prefill_flops(m, 3) == 6912 + 160 + 64 * 6
    # position 5 sees 6 keys
    assert counts.decode_flops(m, 5) == 2 * (1152 + 80) + 64 * 6
    flops, nbytes = counts.flash_prefill(m, 3)
    assert flops == 64 * 6
    # per layer q and out 3*2*4 each, k and v 3*1*4 each, 2 bytes, 2 layers
    assert nbytes == 2 * 2 * (24 + 24 + 12 + 12)
    # rows of 3 and 5 tokens: K+V 8*1*4*2 elements, q+out 2*2*2*4 a row
    assert counts.paged_decode_bytes(m, [3, 5]) == 2 * 2 * (8 * 8 + 2 * 16)


def test_hand_counts_moe():
    m = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 2, "head_dim": 4,
         "d_ff": 99, "vocab": 10, "block_pattern": ["attn_moe"], "window": 3,
         "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 5}}
    # attention 64 + 128 + 64, router 32, two experts 2*3*8*5
    assert counts.layer_params(m) == 256 + 32 + 240
    # position 9 sees the window's 3 keys
    assert counts.decode_flops(m, 9) == 2 * (528 + 80) + 4 * 4 * 2 * 3


@pytest.mark.parametrize("model", [bench_tiny.DENSE, bench_tiny.MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("length", [37, 160])
def test_prefill_flops_match_the_dry_runs_rule(model, length):
    from repro_torch.kernels import _meta
    from repro_torch.models import transformer as T
    cfg = harness.port_config(model)
    params = T.init_abstract(cfg)
    tokens = torch.empty((1, length), dtype=torch.int32, device="meta")
    cache = T.init_cache(cfg, 1, length, device="meta")
    with _meta.tallying() as kt, FlopCounterMode(display=False) as fc:
        T.prefill(params, tokens, cache, cfg)
    assert fc.get_total_flops() + kt.flops == counts.prefill_flops(model, length)
    assert kt.flops == counts.flash_prefill(model, length)[0]
