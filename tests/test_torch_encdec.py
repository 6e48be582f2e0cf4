"""The port's Whisper-style encoder-decoder against the JAX package's
(``repro.models.encdec``): encode, the teacher-forced forward, the fused
decoder prefill and decode steps, on JAX-initialised parameters carried
over by ``repro_torch.convert`` (reduced ``whisper-base``, two layers).
Also the enc-dec traps: the positional tables stay f32, the stacked
encoder / decoder layers decay as JAX's stacked layout decays them, and
the cache crosses over.  Tolerance 1e-4 in f32 (summation order only),
2e-2 in bf16; bf16 caches are compared normwise (2e-2): an entry computed
from bf16 activations that differ by a rounding can land one bf16 step
away, which is most of a small entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import encdec as JE
from repro_torch import configs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T

torch.backends.cuda.matmul.allow_tf32 = False

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
B, T_ENC, LP, MAX_LEN = 2, 12, 5, 10


def _cfgs(dtype="float32"):
    kw = dict(dtype=dtype, vocab=64, n_layers=2)
    return (jreduced(jconfigs.get("whisper-base")).replace(**kw),
            configs.reduced(configs.get("whisper-base")).replace(**kw))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JE.init(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    r = np.random.RandomState(1)
    frames = r.randn(B, T_ENC, cfg.d_model).astype(np.float32)
    toks = r.randint(0, cfg.vocab, (B, LP + 2)).astype(np.int32)
    return request.param, jcfg, cfg, jp, p, frames, toks


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_encode_and_forward_match_jax(model):
    dtype, jcfg, cfg, jp, p, frames, toks = model
    _close(E.encode(p, torch.from_numpy(frames), cfg),
           JE.encode(jp, jnp.asarray(frames), jcfg), dtype)
    want, jaux = JE.forward(jp, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    got, aux = E.forward(p, torch.from_numpy(frames), torch.from_numpy(toks), cfg)
    assert got.shape == (B, LP + 2, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == float(jaux) == 0.0
    _close(got, want, dtype)


def test_prefill_then_decode_match_jax(model):
    """The fused decoder prefill of LP tokens, then two decode steps (the
    second with per-row positions): logits and the K/V caches as JAX's."""
    dtype, jcfg, cfg, jp, p, frames, toks = model
    jenc = JE.encode(jp, jnp.asarray(frames), jcfg)
    enc = E.encode(p, torch.from_numpy(frames), cfg)
    jc = JE.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
    c = E.init_cache(cfg, B, MAX_LEN, device="cpu", dtype=torch.float32)
    jl, jc = JE.decode_prefill(jp, jnp.asarray(toks[:, :LP]), jenc, jc, jcfg)
    got, c = E.decode_prefill(p, torch.from_numpy(toks[:, :LP]), enc, c, cfg)
    _close(got, jl, dtype)
    for pos in (jnp.int32(LP), jnp.asarray([LP + 1, LP + 1], jnp.int32)):
        tok = toks[:, int(np.max(np.asarray(pos)))]
        jl, jc = JE.decode_step(jp, jnp.asarray(tok), jc, pos, jenc, jcfg)
        got, c = E.decode_step(p, torch.from_numpy(tok), c, torch.tensor(np.asarray(pos)),
                               enc, cfg)
        _close(got, jl, dtype)
    for i, pair in enumerate(cache_from_jax(jax.tree.map(np.asarray, jc), cfg, device="cpu")):
        for a, b in zip(c[i], pair):
            if dtype == "float32":
                _close(a, b.numpy(), dtype)
            else:
                assert float((a.float() - b.float()).norm() / b.float().norm()) <= 2e-2


def test_prefill_matches_the_decode_loop():
    """The counterpart of ``test_serve.py::test_encdec_fused_prefill_matches_
    decode_loop``: one fused prefill equals LP decode steps, and the next
    step from either cache agrees (f32, 1e-4)."""
    _, cfg = _cfgs()
    p = E.init(cfg, torch.Generator().manual_seed(0))
    r = np.random.RandomState(4)
    enc = E.encode(p, torch.from_numpy(r.randn(B, 6, cfg.d_model).astype(np.float32)), cfg)
    prompts = torch.from_numpy(r.randint(0, cfg.vocab, (B, 4)).astype(np.int32))
    ref = E.init_cache(cfg, B, 8, device="cpu", dtype=torch.float32)
    for i in range(4):
        ref_logit, ref = E.decode_step(p, prompts[:, i], ref, i, enc, cfg)
    logit, cache = E.decode_prefill(p, prompts, enc,
                                    E.init_cache(cfg, B, 8, device="cpu", dtype=torch.float32),
                                    cfg)
    np.testing.assert_allclose(logit.numpy(), ref_logit.numpy(), **TOL["float32"])
    tok = torch.argmax(logit, -1).to(torch.int32)
    a, _ = E.decode_step(p, tok, cache, 4, enc, cfg)
    b, _ = E.decode_step(p, tok, ref, 4, enc, cfg)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL["float32"])


def test_positional_tables_stay_f32():
    jcfg, cfg = _cfgs("bfloat16")
    jp = JE.init(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    for name, shape in (("enc_pos", (1500, cfg.d_model)), ("dec_pos", (32768, cfg.d_model))):
        assert p[name].dtype == torch.float32 and tuple(p[name].shape) == shape
        np.testing.assert_array_equal(p[name].numpy(), np.asarray(jp[name]))
    assert p["dec_layers"][1]["xattn"]["wq"].dtype == torch.bfloat16
    mine = E.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert mine["enc_pos"].dtype == mine["dec_pos"].dtype == torch.float32


def test_decay_mask_follows_the_stacked_encoder_and_decoder():
    """JAX stacks ``enc_layers`` / ``dec_layers`` over the layers, so every
    LayerNorm scale and bias in them is 2-D there and AdamW decays it; the
    final norms' are 1-D and do not decay."""
    _, cfg = _cfgs()
    mask = T.decay_mask(E.init(cfg, None))
    for group in ("enc_layers", "dec_layers"):
        assert all(mask[group][1]["ln1"].values()) and mask[group][0]["ln2"]["bias"]
    assert mask["dec_layers"][0]["lnx"]["scale"] and mask["enc_pos"] and mask["dec_pos"]
    assert not any(mask["enc_norm"].values()) and not any(mask["final_norm"].values())


def _encdec_ctx_rank(device, params, frames, toks):
    """One of 2 ranks (mesh (1, 2)): encode and the teacher-forced forward
    under a ctx, the frames and tokens split over ``model`` in the
    sequence-sharded attention; the logits gathered over the vocabulary."""
    from repro_torch.config import ParallelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import steps as S
    from repro_torch.parallel.sharding import make_ctx, shard_params
    _, cfg = _cfgs()
    mesh = make_local_mesh(2)
    ctx = make_ctx(mesh, ParallelConfig(fsdp_params=False))
    p = shard_params(params_from_jax(params, cfg, device="cpu"), cfg, ctx)
    with mesh:
        enc = E.encode(p, torch.from_numpy(frames), cfg, ctx=ctx)
        logits, _ = E.forward(p, torch.from_numpy(frames), torch.from_numpy(toks), cfg, ctx=ctx)
        return enc, S.global_rows(logits, ctx, cfg)


def test_encdec_under_a_ctx_raises():
    """Under a mesh ctx the model once raised; it now runs the ported path:
    on 2 gloo CPU ranks ``encode`` and ``forward`` give JAX's single-device
    encoder output and logits (f32) on every rank."""
    from repro_torch.core.mesh import launch
    jcfg, _ = _cfgs()
    jp = JE.init(jax.random.PRNGKey(0), jcfg)
    r = np.random.RandomState(3)
    frames = r.randn(B, T_ENC, jcfg.d_model).astype(np.float32)
    toks = r.randint(0, jcfg.vocab, (B, LP + 1)).astype(np.int32)
    want_enc = JE.encode(jp, jnp.asarray(frames), jcfg)
    want, _ = JE.forward(jp, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    for enc, logits in launch(2, _encdec_ctx_rank, jax.tree.map(np.asarray, jp), frames, toks,
                              device="cpu", timeout=300):
        np.testing.assert_allclose(enc, np.asarray(want_enc), **TOL["float32"])
        np.testing.assert_allclose(logits, np.asarray(want), **TOL["float32"])


def test_pipeline_frames_match_jax():
    """An enc-dec batch carries stub frames (B, 1500, d), the same numbers
    as the JAX pipeline's for the same seed and step."""
    from repro.config import ShapeConfig as JShape
    from repro.data.pipeline import make_batch_iterator as jbatches
    from repro_torch.config import ShapeConfig
    from repro_torch.data import make_batch_iterator
    jcfg, cfg = _cfgs()
    jit = jbatches(jcfg, JShape("t", "train", 16, 2), seed=3, start_step=1)
    it = make_batch_iterator(cfg, ShapeConfig("t", "train", 16, 2), seed=3, start_step=1,
                             device="cpu")
    want, got = next(jit), next(it)
    it.close()
    jit.close()
    assert got["frames"].shape == (2, 1500, cfg.d_model) and got["frames"].dtype == torch.float32
    np.testing.assert_array_equal(got["frames"].numpy(), np.asarray(want["frames"]))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
