"""``bench/reference.py`` against the port's CPU forward in float32 on the
same weights, at reduced width, for the dense and the MoE pattern; the
float8 control against the same logits (it must read far off); and
ChatGLM3-6B's weights and reference logits, at reduced width, as they were
before configurations could name their own model module."""
import hashlib

import pytest
import torch

import bench_tiny
from bench import harness, reference, spec, weights

# sha256 of the leaf plan's repr and of the weights' f32 bytes in plan order,
# for ChatGLM3-6B cut to 2 layers of width 64 (vocab 256, ffn 96), seed
# 2**31 + 2201, made by the harness before model modules were named
GLM_PLAN = "78bf4c887ee6bfbf6bab1eaa8445a32a3844c7d2d753f4348cd5edd2f8767411"
GLM_WEIGHTS = "b4691423f6a5a0f7bf53463e65d79de6be2acdc0dcfcad6db8fa6fe77ac8da1d"


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


def test_chatglm3_weights_and_reference_logits_are_unchanged():
    cfg = spec.config(spec.benchmark(bench_tiny.REPO), "chatglm3-6b", bench_tiny.REPO)
    assert "reference" not in cfg
    model = dict(cfg["model"], n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                 d_ff=96, vocab=256)
    mod = spec.model_module(cfg)
    plan = mod.leaf_plan(model)
    assert hashlib.sha256(repr(plan).encode()).hexdigest() == GLM_PLAN
    params = weights.make(model, 2 ** 31 + 2201, torch.device("cpu"), plan)
    h = hashlib.sha256()
    for path, *_ in plan:
        node = params
        for key in path:
            node = node[key]
        h.update(repr((path, tuple(node.shape), str(node.dtype))).encode())
        h.update(node.float().contiguous().numpy().tobytes())
    assert h.hexdigest() == GLM_WEIGHTS
    tokens = torch.randint(0, 256, (90,), generator=torch.Generator().manual_seed(7))
    assert mod.logits is reference.logits
    assert torch.equal(mod.logits(params, model, tokens, 20),
                       reference.logits(params, model, tokens, 20))
