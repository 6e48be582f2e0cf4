"""The port's mLSTM and sLSTM blocks against the JAX package's
(``repro.models.xlstm``), on the same numpy inputs and JAX-initialised
parameters carried over through ``repro_torch.convert``: the full-sequence
forward, a fused prefill into a seeded cache and decode steps.  Tolerance
1e-4 (f32; the packages differ in summation order only), 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import xlstm as JX
from repro_torch import config
from repro_torch.convert import params_from_jax
from repro_torch.models import xlstm as X

torch.backends.cuda.matmul.allow_tf32 = False

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
KW = dict(name="x", family="ssm", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
          vocab=64, block_pattern=("mlstm", "slstm"), norm="layernorm")
XL = dict(proj_factor=2.0, chunk=4)


def _cfgs(dtype):
    return (jconfig.ModelConfig(**KW, dtype=dtype, xlstm=jconfig.XLSTMConfig(**XL)),
            config.ModelConfig(**KW, dtype=dtype, xlstm=config.XLSTMConfig(**XL)))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def blocks(request):
    dtype = request.param
    jcfg, cfg = _cfgs(dtype)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp = {"mlstm": JX.mlstm_init(k1, jcfg), "slstm": JX.slstm_init(k2, jcfg)}
    tree = {"layers": tuple({kind: jax.tree.map(lambda a: np.asarray(a)[None], jp[kind])}
                            for kind in ("mlstm", "slstm")), "embed": {}, "final_norm": {}}
    layers = params_from_jax(tree, cfg, device="cpu")["layers"]
    return dtype, jcfg, cfg, jp, {"mlstm": layers[0]["mlstm"], "slstm": layers[1]["slstm"]}


def _x(b, s, seed, dtype):
    x = np.random.RandomState(seed).randn(b, s, 32).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_matches_jax(blocks, kind):
    dtype, jcfg, cfg, jp, p = blocks
    jx, x = _x(2, 8, 1, dtype)
    jfn, fn = (JX.mlstm_block, X.mlstm_block) if kind == "mlstm" else \
        (JX.slstm_block, X.slstm_block)
    want, _ = jfn(jp[kind], jx, jcfg)
    got, none = fn(p[kind], x, cfg)
    assert none is None and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_then_decode_matches_jax(blocks, kind):
    """A prefill of 8 tokens from the initial state, then two decode steps:
    outputs and state as JAX's (sLSTM: m starts at -1e30)."""
    dtype, jcfg, cfg, jp, p = blocks
    if kind == "mlstm":
        jfn, fn = JX.mlstm_block, X.mlstm_block
        jc = {"ssm": jnp.zeros((2, 2, 32, 33), jnp.float32)}
        c = X.mlstm_init_cache(2, cfg, "cpu")
    else:
        jfn, fn = JX.slstm_block, X.slstm_block
        jc, c = JX.slstm_init_cache(2, jcfg), X.slstm_init_cache(2, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: v.shape for k, v in jc.items()}
    for s, seed in ((8, 2), (1, 3), (1, 4)):
        jx, x = _x(2, s, seed, dtype)
        want, jc = jfn(jp[kind], jx, jcfg, cache=jc)
        got, c = fn(p[kind], x, cfg, cache=c)
        _close(got, want, dtype)
        for key in jc:
            assert c[key].dtype == torch.float32
            _close(c[key], jc[key], dtype)


def test_slstm_cache_starts_at_the_stabiliser_floor():
    _, cfg = _cfgs("float32")
    c = X.slstm_init_cache(3, cfg, "cpu")
    assert torch.all(c["m"] == -1e30) and not c["c"].any() and not c["n"].any()


def test_mlstm_normaliser_channel_bounds_the_output(blocks):
    """h = num / max(|den|, 1): with v' = [v, 1] the state's last channel is
    the normaliser, and the output before the projections stays bounded by
    the values' scale."""
    dtype, _, cfg, _, p = blocks
    x = torch.randn(1, 8, 32, generator=torch.Generator().manual_seed(5)).to(
        getattr(torch, dtype)) * 50
    got, _ = X.mlstm_block(p["mlstm"], x, cfg)
    assert torch.isfinite(got.float()).all()


def _xlstm_ctx_rank(device, dtype, p, xs):
    """One of 2 ranks (mesh (1, 2)): each block under a ctx (the mLSTM's 2
    heads and the sLSTM's 32 channels split over ``model``), a prefill and
    a decode step from a zero cache (``cache_specs``'s blocks)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import make_ctx, shard_cache, shard_params
    cfg = _cfgs(dtype)[1]
    mesh = make_local_mesh(2)
    ctx = make_ctx(mesh, ParallelConfig(fsdp_params=False))
    layers = [{kind: {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                          {n: torch.from_numpy(t) for n, t in v.items()})
                      for k, v in p[kind].items()}} for kind in ("mlstm", "slstm")]
    local = shard_params({"layers": layers}, cfg, ctx)["layers"]
    caches = shard_cache(T.init_cache(cfg, xs[0].shape[0], 8, device="cpu"), cfg, ctx)
    out = {}
    with mesh:
        for i, (kind, fn) in enumerate((("mlstm", X.mlstm_block), ("slstm", X.slstm_block))):
            cache, ys = caches[i][kind], []
            for x in xs:
                y, cache = fn(local[i][kind], torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
                              cache=cache, ctx=ctx)
                ys.append(y.float())
            out[kind] = torch.cat(ys, dim=1)
    return out


def test_xlstm_under_a_ctx_raises(blocks):
    """Under a mesh ctx the blocks once raised; they now run the ported
    path: on 2 gloo CPU ranks a fused prefill and a decode step of the
    mLSTM (the engine on the rank's head) and of the sLSTM (the recurrence
    on the rank's channels) give JAX's single-device outputs on every rank."""
    from repro_torch.core.mesh import launch
    dtype, jcfg, cfg, jp, p = blocks
    xs = [np.random.RandomState(21 + i).randn(2, n, 32).astype(np.float32)
          for i, n in enumerate((8, 1))]
    want = {}
    for kind, fn, cache in (("mlstm", JX.mlstm_block, {"ssm": jnp.zeros((2, 2, 32, 33))}),
                            ("slstm", JX.slstm_block, JX.slstm_init_cache(2, jcfg))):
        ys = []
        for x in xs:
            y, cache = fn(jp[kind], jnp.asarray(x, dtype), jcfg, cache=cache)
            ys.append(np.asarray(y, np.float32))
        want[kind] = np.concatenate(ys, axis=1)
    nump = {kind: {k: (v.float().numpy() if torch.is_tensor(v) else
                       {n: t.float().numpy() for n, t in v.items()}) for k, v in p[kind].items()}
            for kind in p}
    for got in launch(2, _xlstm_ctx_rank, dtype, nump, xs, device="cpu", timeout=300):
        for kind in ("mlstm", "slstm"):
            _close(torch.from_numpy(got[kind]), want[kind], dtype)
