"""The port's chunked linear-recurrence engine and Mamba2 block against the
JAX package's (``repro.models.ssm``), on the same numpy inputs.

The engine is also held against its own recurrence step, token by token
(the two forms of one recurrence).  The block's parameters cross over
through ``repro_torch.convert``.  Tolerances: f32 1e-5 for the engine (the
two differ in summation order only), 1e-4 for the block (a few products
more); the bf16 engine (``mm_bf16`` with bf16 inputs) 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import ssm as JS
from repro_torch import config
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as S

torch.backends.cuda.matmul.allow_tf32 = False

ENGINE_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _engine_inputs(b=2, s=16, h=3, dk=4, dv=5, seed=0):
    r = np.random.RandomState(seed)
    q, k = (r.randn(b, s, h, dk).astype(np.float32) * 0.5 for _ in range(2))
    v = r.randn(b, s, h, dv).astype(np.float32)
    log_a = -np.abs(r.randn(b, s, h)).astype(np.float32) * 0.3
    gate = r.rand(b, s, h).astype(np.float32)
    state0 = r.randn(b, h, dk, dv).astype(np.float32) * 0.1
    return q, k, v, log_a, gate, state0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunk_engine_matches_recurrence_step(chunk):
    q, k, v, la, g, s0 = _t(*_engine_inputs())
    y, state = S.chunked_linear_attention(q, k, v, la, g, chunk=chunk, state0=s0)
    st, ys = s0, []
    for i in range(q.shape[1]):
        yi, st = S.linear_attention_step(st, q[:, i], k[:, i], v[:, i], la[:, i], g[:, i])
        ys.append(yi)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(), **ENGINE_TOL)
    np.testing.assert_allclose(state.numpy(), st.numpy(), **ENGINE_TOL)


@pytest.mark.parametrize("chunk,seeded", [(4, True), (8, False), (16, True)])
def test_chunk_engine_matches_jax(chunk, seeded):
    q, k, v, la, g, s0 = _engine_inputs(seed=1)
    want_y, want_s = JS.chunked_linear_attention(
        *map(jnp.asarray, (q, k, v, la, g)), chunk=chunk,
        state0=jnp.asarray(s0) if seeded else None)
    y, st = S.chunked_linear_attention(*_t(q, k, v, la, g), chunk=chunk,
                                       state0=torch.from_numpy(s0) if seeded else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **ENGINE_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **ENGINE_TOL)


def test_chunk_engine_bf16_products_match_jax():
    """``mm_bf16``: the L x L products take bf16 operands with f32
    accumulation, in both packages; inputs in bf16."""
    q, k, v, la, g, _ = _engine_inputs(seed=2)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want_y, want_s = JS.chunked_linear_attention(*jb, jnp.asarray(la), jnp.asarray(g),
                                                 chunk=8, mm_bf16=True)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    y, st = S.chunked_linear_attention(*tb, *_t(la, g), chunk=8, mm_bf16=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **BF16_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **BF16_TOL)


def test_chunk_engine_masks_before_exp():
    """A steep decay makes cum_i - cum_j large and positive above the
    diagonal; masked after ``exp`` it would give inf * 0 = NaN."""
    q, k, v, la, g, _ = _t(*_engine_inputs(seed=3))
    y, st = S.chunked_linear_attention(q, k, v, la * 400.0, g, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_chunk_engine_rejects_ragged_chunks():
    q, k, v, la, g, _ = _t(*_engine_inputs(s=12))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.chunked_linear_attention(q, k, v, la, g, chunk=8)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
KW = dict(name="m2", family="hybrid", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
          d_ff=64, vocab=64, dtype="float32", block_pattern=("mamba2",))
SSM = dict(d_state=8, head_dim=8, expand=2, conv_width=4, chunk=4)


@pytest.fixture(scope="module")
def block():
    jcfg = jconfig.ModelConfig(**KW, ssm=jconfig.SSMConfig(**SSM))
    cfg = config.ModelConfig(**KW, ssm=config.SSMConfig(**SSM))
    jp = JS.mamba2_init(jax.random.PRNGKey(0), jcfg)
    # A_log / D / dt_bias away from their constant init, so a mix-up shows
    r = np.random.RandomState(9)
    jp = dict(jp, A_log=jnp.asarray(r.randn(8).astype(np.float32) * 0.3),
              D=jnp.asarray(r.randn(8).astype(np.float32)),
              dt_bias=jnp.asarray(r.randn(8).astype(np.float32) - 1.0))
    wrapped = {"layers": ({"mamba": jax.tree.map(lambda a: np.asarray(a)[None], jp)},)}
    p = params_from_jax(dict(wrapped, embed={}, final_norm={}), cfg, device="cpu")
    return jcfg, cfg, jp, p["layers"][0]["mamba"]


def _x(b, s, seed):
    return np.random.RandomState(seed).randn(b, s, 32).astype(np.float32)


def test_mamba2_forward_matches_jax(block):
    jcfg, cfg, jp, p = block
    x = _x(2, 8, 4)
    want, _ = JS.mamba2_block(jp, jnp.asarray(x), jcfg)
    got, none = S.mamba2_block(p, torch.from_numpy(x), cfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_mamba2_prefill_then_decode_matches_jax(block):
    """A fused prefill from a seeded cache (conv window and SSM state), then
    two decode steps: outputs and every cache leaf as JAX's."""
    jcfg, cfg, jp, p = block
    r = np.random.RandomState(5)
    conv = r.randn(2, 3, 80).astype(np.float32)
    ssm = r.randn(2, 8, 8, 8).astype(np.float32) * 0.1
    jc = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    c = {"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)}
    for s, seed in ((8, 6), (1, 7), (1, 8)):
        x = _x(2, s, seed)
        want, jc = JS.mamba2_block(jp, jnp.asarray(x), jcfg, cache=jc)
        got, c = S.mamba2_block(p, torch.from_numpy(x), cfg, cache=c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]), **BLOCK_TOL)


def test_causal_conv_matches_jax():
    r = np.random.RandomState(10)
    x, w, cache = r.randn(2, 5, 6), r.randn(4, 6), r.randn(2, 3, 6)
    x, w, cache = (a.astype(np.float32) for a in (x, w, cache))
    for c in (None, cache):
        want, wc = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if c is None else jnp.asarray(c))
        got, gc = S._causal_conv(*_t(x, w), None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENGINE_TOL)
        assert (gc is None) == (wc is None)
        if gc is not None:
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_mamba2_init_keeps_f32_leaves(block):
    _, cfg, _, _ = block
    p = S.mamba2_init(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    assert p["in_proj"].dtype == p["out_proj"].dtype == torch.bfloat16
    for name in ("conv_w", "A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32, name


def _mamba2_ctx_rank(device, p, xs):
    """One of 2 ranks (mesh (1, 2)): the block under a ctx, its 8 heads and
    80 conv channels split over ``model``, through a prefill and decode
    steps from a zero cache (``cache_specs``'s blocks)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharding import make_ctx, shard_cache, shard_params
    cfg = config.ModelConfig(**KW, ssm=config.SSMConfig(**SSM))
    mesh = make_local_mesh(2)
    ctx = make_ctx(mesh, ParallelConfig(fsdp_params=False))
    layer = {"mamba": {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                           {n: torch.from_numpy(t) for n, t in v.items()}) for k, v in p.items()}}
    local = shard_params({"layers": [layer]}, cfg, ctx)["layers"][0]["mamba"]
    cache = shard_cache([{"mamba": S.mamba2_init_cache(xs[0].shape[0], cfg, "cpu",
                                                       torch.float32)}], cfg, ctx)[0]["mamba"]
    ys = []
    with mesh:
        for x in xs:
            y, cache = S.mamba2_block(local, torch.from_numpy(x), cfg, cache=cache, ctx=ctx)
            ys.append(y)
    return torch.cat(ys, dim=1)


def test_mamba2_under_a_ctx_raises(block):
    """Under a mesh ctx the block once raised; it now runs the ported path
    (tensor-parallel, the engine on the rank's heads): on 2 gloo CPU ranks a
    fused prefill and two decode steps give JAX's single-device outputs on
    every rank."""
    from repro_torch.core.mesh import launch
    jcfg, cfg, jp, p = block
    xs = [_x(2, 8, 11), _x(2, 1, 12), _x(2, 1, 13)]
    cache = {"conv": jnp.zeros((2, 3, 80)), "ssm": jnp.zeros((2, 8, 8, 8))}
    want = []
    for x in xs:
        y, cache = JS.mamba2_block(jp, jnp.asarray(x), jcfg, cache=cache)
        want.append(np.asarray(y))
    nump = {k: (v.numpy() if torch.is_tensor(v) else {n: t.numpy() for n, t in v.items()})
            for k, v in p.items()}
    for got in launch(2, _mamba2_ctx_rank, nump, xs, device="cpu", timeout=300):
        np.testing.assert_allclose(got, np.concatenate(want, axis=1), **BLOCK_TOL)
