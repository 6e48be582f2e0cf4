"""``bench/reference.py`` against the port's CPU forward in float32 on the
same weights, at reduced width, for the dense and the MoE pattern; and the
float8 control against the same logits (it must read far off)."""
import pytest
import torch

import bench_tiny
from bench import harness, reference, weights


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


@pytest.mark.parametrize("model", [bench_tiny.DENSE, bench_tiny.MOE], ids=["dense", "moe"])
def test_reference_matches_the_ports_forward(model):
    from repro_torch.models import transformer as T
    params = weights.make(model, 2 ** 33 + 1, torch.device("cpu"))
    cfg = harness.port_config(model).replace(dtype="float32")
    tokens = torch.randint(0, model["vocab"], (1, 150), generator=torch.Generator().manual_seed(3))
    want = T.forward(params, tokens, cfg)[0, -40:]
    got = reference.logits(params, model, tokens[0], 40)
    scale = want.abs().max()
    assert (got - want).abs().max() / scale < 1e-4
    low = reference.logits(params, model, tokens[0], 40, fp8=True)
    assert (low - want).abs().max() / scale > 1e-2
