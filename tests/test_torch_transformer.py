"""Port's decoder against the JAX package's: forward, chunked paged prefill
and paged decode, on JAX-initialised parameters carried over by
``repro_torch.convert`` (reduced ``llama3.2-3b``, two layers, f32).

Tolerance 1e-4 on logits: f32 throughout, the two packages differ only in
summation order across two layers and the vocabulary projection.  The
paged arenas hold bf16, as in both packages; an arena value computed from
f32 numbers that agree to 1e-6 can still round to neighbouring bf16 values,
so arenas are compared to one bf16 ulp (rtol 2**-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-4, rtol=1e-4)
BLOCK, N_BLOCKS = 4, 12


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jconfigs.get("llama3.2-3b")).replace(
        dtype="float32", param_dtype="float32", n_layers=2)
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", n_layers=2)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(n, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (n,)).astype(np.int32)


def _prefill_port(params, cfg, cache, prompt, table, chunk):
    logits = None
    for lo in range(0, len(prompt), chunk):
        ln = min(chunk, len(prompt) - lo)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :ln] = prompt[lo:lo + ln]
        logits, cache = T.prefill_paged(params, torch.from_numpy(toks), cache, cfg,
                                        pos0=lo, block_tables=torch.from_numpy(table[None]),
                                        length=ln)
    return logits, cache


def test_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    toks = np.stack([_tokens(9, cfg.vocab, 0), _tokens(9, cfg.vocab, 1)])
    want, _ = JT.forward(jparams, jnp.asarray(toks), jcfg)
    got = T.forward(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 9, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_then_decode_matches_jax(model):
    """Two requests prefilled in chunks of 4 (a padded final chunk) through
    their tables, then two decode steps over three rows: the two requests
    and a dead row (all -1 table, a parked slot) whose writes must drop."""
    jcfg, cfg, jparams, params = model
    prompts = [_tokens(9, cfg.vocab, 2), _tokens(5, cfg.vocab, 3)]
    tables = np.array([[3, 7, 1, -1], [0, 5, -1, -1], [-1, -1, -1, -1]], np.int32)
    jpre = jax.jit(lambda p, t, c, pos0, tb, ln: JT.prefill_paged(
        p, t, c, jcfg, pos0=pos0, block_tables=tb, length=ln))
    jdec = jax.jit(lambda p, t, c, pos, tb: JT.decode_step(p, t, c, pos, jcfg,
                                                           block_tables=tb))
    jcache = JT.init_paged_cache(jcfg, N_BLOCKS, BLOCK)
    cache = T.init_paged_cache(cfg, N_BLOCKS, BLOCK, device="cpu")
    first = []
    for r, prompt in enumerate(prompts):
        for lo in range(0, len(prompt), 4):
            ln = min(4, len(prompt) - lo)
            toks = np.zeros((1, 4), np.int32)
            toks[0, :ln] = prompt[lo:lo + ln]
            jl, jcache = jpre(jparams, jnp.asarray(toks), jcache, jnp.int32(lo),
                              jnp.asarray(tables[r:r + 1]), jnp.int32(ln))
            pl, cache = T.prefill_paged(params, torch.from_numpy(toks), cache, cfg,
                                        pos0=lo, block_tables=torch.from_numpy(tables[r:r + 1]),
                                        length=ln)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        first.append(int(np.argmax(np.asarray(jl)[0])))

    tok = np.array(first + [0], np.int32)
    pos = np.array([9, 5, 3], np.int32)
    for _ in range(2):
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
                          jnp.asarray(tables))
        pl, cache = T.decode_step(params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(pos), cfg,
                                  block_tables=torch.from_numpy(tables))
        # rows 0 and 1 are live; the dead row's output is never read
        np.testing.assert_allclose(pl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    for i in range(cfg.n_layers):
        for j in range(2):                               # K and V arenas
            np.testing.assert_allclose(cache[i][j].float().numpy(),
                                       np.asarray(jcache[0]["attn"][j][i], np.float32),
                                       atol=1e-5, rtol=2 ** -7)


def test_decode_matches_forward(model):
    """The page view equals dense attention: teacher-forced decode logits
    after a chunked prefill equal ``forward`` over the full sequences (f32
    arenas, so both paths see the same K/V numbers)."""
    _, cfg, _, params = model
    seqs = [_tokens(10, cfg.vocab, 4), _tokens(7, cfg.vocab, 5)]
    prompt_lens = [6, 3]
    tables = np.array([[4, 2, 9, -1], [11, 0, -1, -1]], np.int32)
    cache = T.init_paged_cache(cfg, N_BLOCKS, BLOCK, device="cpu", dtype=torch.float32)
    for r in range(2):
        logits, cache = _prefill_port(params, cfg, cache, seqs[r][:prompt_lens[r]],
                                      tables[r], chunk=4)
        ref = T.forward(params, torch.from_numpy(seqs[r][None]), cfg)
        torch.testing.assert_close(logits[0], ref[0, prompt_lens[r] - 1], **TOL)
    refs = [T.forward(params, torch.from_numpy(s[None]), cfg)[0] for s in seqs]
    pos = np.array(prompt_lens, np.int32)
    for _ in range(4):
        tok = np.array([seqs[r][pos[r]] for r in range(2)], np.int32)
        logits, cache = T.decode_step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(pos), cfg,
                                      block_tables=torch.from_numpy(tables))
        for r in range(2):
            torch.testing.assert_close(logits[r], refs[r][pos[r]], **TOL)
        pos = pos + 1


def test_final_chunk_pad_overflow_does_not_corrupt(model):
    """chunk 9, block 4, prompt 13, a 4-page table: the final chunk's pad
    positions 16 and 17 fall one page past the table.  They must drop; a
    clamped index would write them over the last live page (positions 12
    and 13 of block 1)."""
    _, cfg, _, params = model
    prompt = _tokens(13, cfg.vocab, 6)
    table = np.array([2, 0, 3, 1], np.int32)
    padded = T.init_paged_cache(cfg, N_BLOCKS, BLOCK, device="cpu", dtype=torch.float32)
    logits, padded = _prefill_port(params, cfg, padded, prompt, table, chunk=9)
    whole = T.init_paged_cache(cfg, N_BLOCKS, BLOCK, device="cpu", dtype=torch.float32)
    _, whole = _prefill_port(params, cfg, whole, prompt, table, chunk=13)
    for (pk, pv), (wk, wv) in zip(padded, whole):
        torch.testing.assert_close(pk[1, 0], wk[1, 0], **TOL)   # position 12
        torch.testing.assert_close(pv[1, 0], wv[1, 0], **TOL)
    ref = T.forward(params, torch.from_numpy(prompt[None]), cfg)
    torch.testing.assert_close(logits[0], ref[0, -1], **TOL)
