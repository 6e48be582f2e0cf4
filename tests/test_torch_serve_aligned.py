"""Port's end-aligned serving engine against the JAX package's.

JAX initialises the parameters of the JAX tests' ``tiny`` llama (reduced,
f32, vocab 64), ``repro_torch.convert`` carries them (and caches) over, and
the same numpy tokens go through both packages: the fused prefill, the
end-aligned decode step over per-row positions, the SWA ring, and
``Scheduler(paged=False)``.

Tolerance 1e-4 on f32 logits (summation order across two layers and the
vocabulary projection, as in ``test_torch_transformer.py``).  Caches hold
bf16 in both packages unless a test asks for f32; a bf16 cache value
computed from f32 numbers that agree to 1e-6 can round to the neighbouring
bf16 value, so bf16 caches are compared to one bf16 ulp (rtol 2**-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ParallelConfig
from repro.launch.scheduler import Request as JRequest
from repro.launch.scheduler import Scheduler as JScheduler
from repro.launch.train import reduced as jreduced
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.scheduler import Request, Scheduler
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_CACHE = dict(atol=1e-5, rtol=2 ** -7)
PCFG = ParallelConfig(remat="none", fsdp_params=False)


def _tiny(**kw):
    jcfg = jreduced(jconfigs.get("llama3.2-3b")).replace(
        dtype="float32", param_dtype="float32", vocab=64, **kw)
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", vocab=64, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = _tiny()
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                               device="cpu")


def _with(tiny, **kw):
    """The fixture's parameters under a config changed by ``kw`` (window)."""
    _, _, jparams, params = tiny
    jcfg, cfg = _tiny(**kw)
    return jcfg, cfg, jparams, params


def _tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _np_cache(jcache):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)


def _assert_cache_close(cache, jcache, tol):
    jc = _np_cache(jcache)
    for i, (k, v) in enumerate(cache):
        for got, want in ((k, jc[0]["attn"][0][i]), (v, jc[0]["attn"][1][i])):
            np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _port_decode_loop(cfg, params, prompts, max_len, dtype=torch.float32):
    """Token-by-token reference of the port: (last logits, cache) after
    feeding every prompt token through the end-aligned decode step."""
    cache = T.init_cache(cfg, prompts.shape[0], max_len, device="cpu", dtype=dtype)
    logit = None
    for i in range(prompts.shape[1]):
        logit, cache = T.decode_step(params, torch.from_numpy(prompts[:, i]), cache, i, cfg)
    return logit, cache


# ---------------------------------------------------------------------------
# The model calls against JAX's
# ---------------------------------------------------------------------------
def test_prefill_logits_and_cache_match_jax(tiny):
    """A right-padded batch into a bf16 cache longer than the bucket: the
    attention reads the bf16 rows just written, as JAX's does."""
    jcfg, cfg, jparams, params = tiny
    toks = _tokens((2, 8), cfg.vocab, 0)
    lens = np.array([8, 5], np.int32)
    toks[1, 5:] = 0
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, 2, 12), jcfg,
                            length=jnp.asarray(lens))
    pl, cache = T.prefill(params, torch.from_numpy(toks),
                          T.init_cache(cfg, 2, 12, device="cpu"), cfg,
                          length=torch.from_numpy(lens))
    assert pl.dtype == torch.float32 and tuple(pl.shape) == (2, cfg.vocab)
    assert cache[0][0].dtype == torch.bfloat16
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(cache, jcache, BF16_CACHE)


def test_decode_step_from_converted_cache_matches_jax(tiny):
    """The port's end-aligned decode step from ``cache_from_jax`` of JAX's
    prefill cache, per-row positions (5 and 8), three steps."""
    jcfg, cfg, jparams, params = tiny
    toks = _tokens((2, 8), cfg.vocab, 1)
    lens = np.array([5, 8], np.int32)
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, 2, 12), jcfg,
                            length=jnp.asarray(lens))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, device="cpu")
    assert len(cache) == cfg.n_layers and cache[0][0].dtype == torch.bfloat16
    _assert_cache_close(cache, jcache, dict(atol=0, rtol=0))
    jdec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    pos = lens.copy()
    for _ in range(3):
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        pl, cache = T.decode_step(params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    _assert_cache_close(cache, jcache, BF16_CACHE)


def test_swa_ring_prefill_and_decode_match_jax(tiny):
    """window 4: a prompt of 8 overflows the ring; the ring write, the
    in-flight flash attention and two ring decode steps, against JAX."""
    jcfg, cfg, jparams, params = _with(tiny, window=4)
    toks = _tokens((2, 8), cfg.vocab, 2)
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, 2, 16), jcfg)
    pl, cache = T.prefill(params, torch.from_numpy(toks),
                          T.init_cache(cfg, 2, 16, device="cpu"), cfg)
    assert cache[0][0].shape[1] == 4
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    tok, pos = np.asarray(jl).argmax(-1).astype(np.int32), np.array([8, 8], np.int32)
    for _ in range(2):
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        pl, cache = T.decode_step(params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok, pos = np.asarray(jl).argmax(-1).astype(np.int32), pos + 1
    _assert_cache_close(cache, jcache, BF16_CACHE)


def test_swa_ring_decode_through_the_kernel_matches_jax(tiny):
    """window 16: a ring of 16 slots takes the paged-attention kernel's
    route (its plain version here); rows at 11 and 13 decode eight steps
    each, across the ring's first wrap, against JAX."""
    jcfg, cfg, jparams, params = _with(tiny, window=16)
    toks = _tokens((2, 13), cfg.vocab, 4)
    lens = np.array([11, 13], np.int32)
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, 2, 32), jcfg,
                            length=jnp.asarray(lens))
    pl, cache = T.prefill(params, torch.from_numpy(toks),
                          T.init_cache(cfg, 2, 32, device="cpu"), cfg,
                          length=torch.from_numpy(lens))
    assert cache[0][0].shape[1] == 16
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    tok, pos = np.asarray(jl).argmax(-1).astype(np.int32), lens.copy()
    for _ in range(8):
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        pl, cache = T.decode_step(params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok, pos = np.asarray(jl).argmax(-1).astype(np.int32), pos + 1
    assert (pos > 16).all()
    _assert_cache_close(cache, jcache, BF16_CACHE)


def test_parked_row_write_past_the_cache_is_dropped(tiny):
    """A row at ``pos == max_len`` (a parked slot) rides the decode step:
    its write drops, never clamps onto a live slot, and the live row's
    logits are JAX's."""
    jcfg, cfg, jparams, params = tiny
    max_len = 6
    toks = _tokens((2, 6), cfg.vocab, 3)
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, 2, max_len), jcfg,
                            length=jnp.asarray([6, 3], jnp.int32))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, device="cpu")
    before = [(k.clone(), v.clone()) for k, v in cache]
    tok, pos = np.array([5, 7], np.int32), np.array([max_len, 3], np.int32)
    jl, jcache = JT.decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg)
    pl, cache = T.decode_step(params, torch.from_numpy(tok), cache, torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(pl.numpy()[1], np.asarray(jl)[1], **TOL)
    for (k, v), (k0, v0) in zip(cache, before):
        assert torch.equal(k[0], k0[0]) and torch.equal(v[0], v0[0])    # dropped
        assert not torch.equal(k[1, 3], k0[1, 3])                       # written
    _assert_cache_close(cache, jcache, BF16_CACHE)


# ---------------------------------------------------------------------------
# Fused prefill oracles (the port's counterparts of tests/test_serve.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 64])
def test_fused_prefill_matches_decode_loop(tiny, window):
    """window 64 is the reduced chatglm's: longer than the cache, so the
    prefill goes through the kernel with the window mask."""
    _, cfg, _, params = _with(tiny, window=window)
    b, lp, max_len = 2, 4, 8
    prompts = _tokens((b, lp), cfg.vocab, 4)
    ref_logit, ref_cache = _port_decode_loop(cfg, params, prompts, max_len)
    logit, cache = T.prefill(params, torch.from_numpy(prompts),
                             T.init_cache(cfg, b, max_len, device="cpu", dtype=torch.float32),
                             cfg)
    torch.testing.assert_close(logit, ref_logit, **TOL)
    # one more decode step from both caches also agrees (the cache state,
    # not just the logits, is equivalent)
    tok = torch.argmax(logit, dim=-1).to(torch.int32)
    nxt_f, _ = T.decode_step(params, tok, cache, lp, cfg)
    nxt_r, _ = T.decode_step(params, tok, ref_cache, lp, cfg)
    torch.testing.assert_close(nxt_f, nxt_r, **TOL)


def test_fused_prefill_right_padded_lengths(tiny):
    """Per-row true lengths on a right-padded batch: each row's last logits
    equal its own unpadded run (pad tokens are causally invisible)."""
    _, cfg, _, params = tiny
    lens, lb, max_len = [5, 3], 8, 12
    rng = np.random.RandomState(2)
    toks = np.zeros((2, lb), np.int32)
    rows = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32) for n in lens]
    for r, row in enumerate(rows):
        toks[r, :len(row)] = row
    logit, _ = T.prefill(params, torch.from_numpy(toks),
                         T.init_cache(cfg, 2, max_len, device="cpu", dtype=torch.float32),
                         cfg, length=torch.tensor(lens, dtype=torch.int32))
    for r, row in enumerate(rows):
        ref, _ = _port_decode_loop(cfg, params, row[None], max_len)
        torch.testing.assert_close(logit[r], ref[0], **TOL)


def test_fused_prefill_prompt_longer_than_window(tiny):
    """SWA ring: a prompt longer than the window prefills the trailing ring
    slots, and the next ring decode step matches the per-token loop (which
    also exercises the pre-wrap slot-validity mask)."""
    _, cfg, _, params = _with(tiny, window=4)
    b, lp, max_len = 2, 8, 16
    prompts = _tokens((b, lp), cfg.vocab, 3)
    ref_logit, ref_cache = _port_decode_loop(cfg, params, prompts, max_len)
    logit, cache = T.prefill(params, torch.from_numpy(prompts),
                             T.init_cache(cfg, b, max_len, device="cpu", dtype=torch.float32),
                             cfg)
    torch.testing.assert_close(logit, ref_logit, **TOL)
    tok = torch.argmax(logit, dim=-1).to(torch.int32)
    nxt_f, _ = T.decode_step(params, tok, cache, lp, cfg)
    nxt_r, _ = T.decode_step(params, tok, ref_cache, lp, cfg)
    torch.testing.assert_close(nxt_f, nxt_r, **TOL)


def test_padded_prefill_rejects_bucket_beyond_ring(tiny):
    """A right-padded bucket longer than the SWA ring would keep pad K/V in
    the cache (the trailing-window write can't see per-row lengths)."""
    _, cfg, _, params = _with(tiny, window=4)
    with pytest.raises(NotImplementedError, match="cache ring"):
        T.prefill(params, torch.zeros((1, 8), dtype=torch.int32),
                  T.init_cache(cfg, 1, 16, device="cpu"), cfg,
                  length=torch.tensor([3], dtype=torch.int32))


def test_prefill_step_takes_a_batch_dict(tiny):
    _, cfg, _, params = tiny
    toks = torch.from_numpy(_tokens((1, 6), cfg.vocab, 5))
    step = S.make_prefill_step(cfg)
    a, _ = step(params, {"tokens": toks}, T.init_cache(cfg, 1, 8, device="cpu"))
    b, _ = step(params, {"tokens": toks, "length": torch.tensor([6])},
                T.init_cache(cfg, 1, 8, device="cpu"))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    greedy, _ = S.make_decode_step(cfg)(params, torch.argmax(a, -1).to(torch.int32),
                                        T.init_cache(cfg, 1, 8, device="cpu"),
                                        torch.tensor([0], dtype=torch.int32))
    assert greedy.dtype == torch.int32 and tuple(greedy.shape) == (1,)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def _mix(vocab, spec, seed):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, (lp,)).astype(np.int32) for lp, _, _ in spec]
    return ([JRequest(rid=i, prompt=prompts[i], gen=g, arrival=a)
             for i, (_, g, a) in enumerate(spec)],
            [Request(rid=i, prompt=prompts[i], gen=g, arrival=a)
             for i, (_, g, a) in enumerate(spec)])


@pytest.mark.parametrize("spec,max_len", [
    # staggered arrivals, an empty prompt, two slots so requests queue and
    # slots are reused, prompts padded to bucket 4
    ([(5, 3, 0), (2, 4, 0), (7, 2, 1), (0, 3, 3)], 16),
    # an empty prompt with gen == max_len parks at pos == max_len while the
    # other slot decodes; its slot is then reused
    ([(0, 8, 0), (3, 5, 6), (2, 3, 9)], 8),
])
def test_greedy_tokens_identical_to_jax(tiny, spec, max_len):
    jcfg, cfg, jparams, params = tiny
    jreqs, reqs = _mix(cfg.vocab, spec, 7)
    want = JScheduler(jcfg, PCFG, jparams, slots=2, max_len=max_len, bucket=4).run(jreqs)
    sched = Scheduler(cfg, params, slots=2, max_len=max_len, bucket=4)
    positions, step = [], sched._decode
    sched._decode = lambda p, tok, c, pos: (positions.append(pos.clone()), step(p, tok, c, pos))[1]
    got = sched.run(reqs)
    parked = any(bool((pos == max_len).any()) for pos in positions)
    assert parked == (spec[0][1] == max_len)
    for i, (lp, gen, _) in enumerate(spec):
        assert got["completions"][i].tokens == want["completions"][i].tokens, i
        assert len(got["completions"][i].tokens) == gen
    assert got["ticks"] == want["ticks"]
    assert got["prefills"] == sum(1 for lp, _, _ in spec if lp > 0)
    assert "pool" not in got


def test_sampling_is_reproducible_from_the_seed(tiny):
    _, cfg, _, params = tiny
    _, reqs = _mix(cfg.vocab, [(5, 6, 0), (3, 6, 1), (0, 4, 2)], 8)
    sched = Scheduler(cfg, params, slots=2, max_len=16, bucket=4, temperature=0.9,
                      top_p=0.95, seed=11)
    a = sched.run(reqs)
    sched.reset()
    b = sched.run(reqs)
    c = Scheduler(cfg, params, slots=2, max_len=16, bucket=4, temperature=0.9,
                  top_p=0.95, seed=12).run(reqs)
    toks = [[r["completions"][i].tokens for i in range(3)] for r in (a, b, c)]
    assert toks[0] == toks[1]
    assert toks[0] != toks[2]
    assert all(0 <= t < cfg.vocab for row in toks[0] for t in row)


def test_engine_limits_are_named(tiny):
    jcfg, cfg, jparams, params = tiny
    sched = Scheduler(cfg, params, slots=1, max_len=16)
    with pytest.raises(ValueError, match="end-aligned slot capacity max_len=16"):
        sched.submit(Request(rid=0, prompt=np.zeros(12, np.int32), gen=5))
    _, swa, _, _ = _with(tiny, window=8)
    with pytest.raises(NotImplementedError, match="attention window 8"):
        Scheduler(swa, params, slots=1, max_len=16)
    assert Scheduler(swa, params, slots=1, max_len=8).cache[0][0].shape[1] == 8


def test_serve_cli_end_aligned_by_default(capsys):
    out = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                      "--prompt-len", "9", "--gen", "3", "--slots", "2", "--bucket", "4"])
    assert sorted(out["completions"]) == [0, 1, 2]
    assert all(len(c.tokens) == 3 for c in out["completions"].values())
    assert out["prefills"] == 3 and "pool" not in out
    text = capsys.readouterr().out
    assert "end-aligned" in text and "tok/s" in text
    naive = serve.main(["--device", "cpu", "--reduced", "--requests", "2",
                        "--prompt-len", "4", "--gen", "2", "--naive"])
    assert sorted(naive["completions"]) == [0, 1]
