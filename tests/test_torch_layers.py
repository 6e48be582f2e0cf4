"""Port's transformer layers against the JAX package's, in f32.

Reduced ``llama3.2-3b`` (``dtype="float32"``): JAX initialises the
parameters, ``repro_torch.convert`` carries them over, and the same numpy
inputs go through both packages' functions.  Tolerance 1e-5: the two differ
only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**kw):
    """The same reduced f32 config in both packages."""
    jcfg = jreduced(jconfigs.get("llama3.2-3b")).replace(
        dtype="float32", param_dtype="float32", **kw)
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, cfg, device="cpu")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_convert_keeps_layout_and_unstacks_layers(model):
    jcfg, cfg, jparams, params = model
    assert len(params["layers"]) == cfg.n_layers
    wq = np.asarray(jparams["layers"][0]["attn"]["wq"][0])
    assert tuple(params["layers"][0]["attn"]["wq"].shape) == wq.shape   # (d_in, d_out)
    _close(params["layers"][0]["attn"]["wq"], wq, atol=0, rtol=0)
    assert "unembed" not in params["embed"]                              # tied
    assert params["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jcfg, cfg = _cfgs(norm=norm)
    rng = np.random.RandomState(1)
    p = {"scale": rng.randn(cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.randn(cfg.d_model).astype(np.float32)
    x = _x((2, 5, cfg.d_model), 2) * 3.0 + 0.5
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg)
    _close(got, want)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope(fraction, per_row):
    """Shared (S,) positions, and per-row (B, S) positions as the decode
    path passes them; ``fraction`` 0.5 is the chatglm partial rotation."""
    jcfg, cfg = _cfgs(rope_fraction=fraction, rope_theta=500000.0)
    x = _x((3, 4, 2, cfg.hd), 3)
    if per_row:
        pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [500, 501, 502, 503]], np.int32)
    else:
        pos = np.arange(4, dtype=np.int32) + 11
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), cfg)
    _close(got, want)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    jcfg, cfg = _cfgs(act=act)
    jp = JL.mlp_init(jax.random.PRNGKey(3), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _x((2, 3, cfg.d_model), 4)
    _close(L.mlp(p, torch.from_numpy(x), cfg), JL.mlp(jp, jnp.asarray(x), jcfg))


def test_attention_no_cache(model):
    jcfg, cfg, jparams, params = model
    x = _x((2, 7, cfg.d_model), 5)
    pos = np.arange(7, dtype=np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["attn"])
    want, _ = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got, cache = L.attention(params["layers"][0]["attn"], torch.from_numpy(x),
                             torch.from_numpy(pos), cfg)
    assert cache is None
    _close(got, want)


def test_sdpa_per_row_offsets_and_valid_lengths():
    """The per-row query offsets and valid-key counts of continuous
    batching, as ``_sdpa`` takes them."""
    rng = np.random.RandomState(6)
    q = rng.randn(2, 1, 2, 3, 8).astype(np.float32)
    k = rng.randn(2, 6, 2, 8).astype(np.float32)
    v = rng.randn(2, 6, 2, 8).astype(np.float32)
    off = np.array([2, 5], np.int32)
    kvv = np.array([3, 6], np.int32)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    window=None, q_offset=jnp.asarray(off),
                    kv_len_valid=jnp.asarray(kvv))
    got = L._sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  causal=True, window=None, q_offset=torch.from_numpy(off),
                  kv_len_valid=torch.from_numpy(kvv))
    _close(got, want)


def test_embed_and_logits(model):
    jcfg, cfg, jparams, params = model
    toks = np.array([[1, 5, 511], [0, 0, 7]], np.int32)
    h = JL.embed(jparams["embed"], jnp.asarray(toks), jcfg)
    got_h = L.embed(params["embed"], torch.from_numpy(toks), cfg)
    _close(got_h, h)
    x = _x((2, 3, cfg.d_model), 7)
    got = L.logits(params["embed"], torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32
    _close(got, JL.logits(jparams["embed"], jnp.asarray(x), jcfg))
