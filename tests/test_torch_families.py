"""The other model families end to end on the CPU, the port against the JAX
package: the counterpart of ``test_arch_smoke.py`` (forward, one train
step, prefill and decode per arch) and of ``test_serve.py``'s recurrent
and enc-dec serving tests.

Each arch is its reduced config cut to a small hand-built one that keeps
its kinds: Mixtral (``attn_moe``, sliding window), Kimi-K2 (``attn_moe``
with a shared expert), Zamba2 (``mamba2``, ``mamba2_attn`` with the shared
attention block), xLSTM (``mlstm``, ``slstm``) and Whisper (enc-dec), f32,
vocabulary 64.  JAX initialises the train state, ``repro_torch.convert``
carries it over, and the same numpy batches go through both.  Tolerances:
logits 1e-4; loss relative 1e-5 and each gradient leaf normwise 1e-4; the
parameters after one step normwise 1e-4 (AdamW's first step is nearly
sign(g), so entries are not compared one by one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.parallel import steps as JS
from repro_torch import configs
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.convert import cache_from_jax, params_from_jax, train_state_from_jax
from repro_torch.launch import serve, train
from repro_torch.launch.scheduler import Request, Scheduler, make_requests
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S
from repro_torch.tree import leaves, tree_unflatten

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(atol=1e-4, rtol=1e-4)
B, SEQ = 2, 16
ARCHS = {
    "mixtral-8x22b": dict(window=8),
    "kimi-k2-1t-a32b": dict(),
    "zamba2-1.2b": dict(block_pattern=("mamba2", "mamba2_attn")),
    "xlstm-1.3b": dict(block_pattern=("mlstm", "slstm")),
    "whisper-base": dict(),
}
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10, z_loss=0.0)


def _cfgs(arch):
    """The arch's reduced config in each package, two layers, f32,
    vocabulary 64, chunk 8 for the recurrent engines."""
    kw = dict(dtype="float32", vocab=64, n_layers=2, **ARCHS[arch])
    out = []
    for c in (jreduced(jconfigs.get(arch)), configs.reduced(configs.get(arch))):
        extra = {n: dataclasses.replace(getattr(c, n), chunk=8)
                 for n in ("ssm", "xlstm") if getattr(c, n)}
        out.append(c.replace(**kw, **extra))
    return out


def _batch(cfg, seed=0):
    r = np.random.RandomState(seed)
    out = {"tokens": r.randint(0, cfg.vocab, (B, SEQ)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = r.randn(B, 12, cfg.d_model).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def states():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = _cfgs(arch)
            jp = jconfig.ParallelConfig(remat="none", fsdp_params=False)
            jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jp)
            cache[arch] = (jcfg, cfg, jstate, jax.tree.map(np.asarray, jstate))
        return cache[arch]

    return get


def _normwise(a, b) -> float:
    return float((a.float() - b.float()).norm() / max(float(b.float().norm()), 1e-30))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch, states):
    jcfg, cfg, jstate, nstate = states(arch)
    params = params_from_jax(nstate["params"], cfg, device="cpu")
    batch = _batch(cfg)
    if cfg.enc_dec:
        want, jaux = JE.forward(jstate["params"], jnp.asarray(batch["frames"]),
                                jnp.asarray(batch["tokens"]), jcfg)
        got, aux = E.forward(params, torch.from_numpy(batch["frames"]),
                             torch.from_numpy(batch["tokens"]), cfg)
    else:
        want, jaux = JT.forward(jstate["params"], jnp.asarray(batch["tokens"]), jcfg)
        got, aux = T.forward(params, torch.from_numpy(batch["tokens"]), cfg, return_aux=True)
    assert got.shape == (B, SEQ, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == bool(cfg.moe)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_jax(arch, states):
    """Loss (with the aux term) and each gradient leaf from the same state,
    then one train step each (clip, warmup-cosine rate, AdamW with the
    stacked layout's weight decay): loss, grad norm and the parameters."""
    jcfg, cfg, jstate, nstate = states(arch)
    jp = jconfig.ParallelConfig(remat="none", fsdp_params=False)
    pcfg = ParallelConfig(remat="none", fsdp_params=False)
    nb = _batch(cfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jloss = JS.make_loss_fn(jcfg, jp, jconfig.TrainConfig(**TCFG), None)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jstate["params"], jb)
    state = train_state_from_jax(nstate, cfg, device="cpu")
    live = [t.detach().clone().requires_grad_(True) for t in leaves(state["params"])]
    loss, metrics = S.make_loss_fn(cfg, pcfg, TrainConfig(**TCFG))(
        tree_unflatten(state["params"], live), tb)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]), rtol=1e-5, atol=1e-7)
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jg), cfg, device="cpu",
                                  dtype=torch.float32))
    for g, w in zip(grads, want):
        assert _normwise(g, w) <= 1e-4

    jnew, jmet = jax.jit(JS.make_train_step(jcfg, jp, jconfig.TrainConfig(**TCFG), None))(
        jstate, jb)
    new, met = S.make_train_step(cfg, pcfg, TrainConfig(**TCFG))(state, tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * abs(float(jmet[key])), key
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jnew["params"]), cfg, device="cpu"))
    for a, b in zip(leaves(new["params"]), want):
        assert _normwise(a, b) <= 1e-4


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(arch, states):
    """An unpadded fused prefill of 8 tokens (enc-dec: after encoding the
    frames), then two decode steps at per-row positions: logits, and the
    caches (K/V rows and recurrent state) after them."""
    jcfg, cfg, jstate, nstate = states(arch)
    params = params_from_jax(nstate["params"], cfg, device="cpu")
    nb = _batch(cfg, seed=2)
    toks, lp, max_len = nb["tokens"], 8, 12
    f32 = dict(dtype=jnp.float32)
    if cfg.enc_dec:
        jenc = JE.encode(jstate["params"], jnp.asarray(nb["frames"]), jcfg)
        enc = E.encode(params, torch.from_numpy(nb["frames"]), cfg)
        jl, jc = JE.decode_prefill(jstate["params"], jnp.asarray(toks[:, :lp]), jenc,
                                   JE.init_cache(jcfg, B, max_len, **f32), jcfg)
        got, c = E.decode_prefill(params, torch.from_numpy(toks[:, :lp]), enc,
                                  E.init_cache(cfg, B, max_len, device="cpu",
                                               dtype=torch.float32), cfg)
        jstep = lambda t, c, p: JE.decode_step(jstate["params"], t, c, p, jenc, jcfg)
        step = lambda t, c, p: E.decode_step(params, t, c, p, enc, cfg)
    else:
        jl, jc = JT.prefill(jstate["params"], jnp.asarray(toks[:, :lp]),
                            JT.init_cache(jcfg, B, max_len, **f32), jcfg)
        got, c = T.prefill(params, torch.from_numpy(toks[:, :lp]),
                           T.init_cache(cfg, B, max_len, device="cpu", dtype=torch.float32), cfg)
        jstep = lambda t, c, p: JT.decode_step(jstate["params"], t, c, p, jcfg)
        step = lambda t, c, p: T.decode_step(params, t, c, p, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    for i in range(2):
        pos = np.full((B,), lp + i, np.int32)
        jl, jc = jstep(jnp.asarray(toks[:, lp + i]), jc, jnp.asarray(pos))
        got, c = step(torch.from_numpy(toks[:, lp + i]), c, torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jc), cfg, device="cpu")
    for a, b in zip(leaves(c), leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **TOL)


def test_every_registered_config_builds():
    """Published widths on the ``meta`` device: every arch, enc-dec too."""
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        params = (E.init if cfg.enc_dec else T.init)(cfg, None)
        n = sum(t.numel() for t in leaves(params))
        assert all(t.device.type == "meta" for t in leaves(params))
        if arch in ("mixtral-8x22b", "kimi-k2-1t-a32b", "zamba2-1.2b", "llama3.2-3b"):
            assert abs(n - cfg.param_counts()["total"]) <= 1e-4 * n, arch


# ---------------------------------------------------------------------------
# serving: the counterparts of test_serve.py's recurrent and enc-dec tests
# ---------------------------------------------------------------------------
def _tiny(arch, pattern=None):
    _, cfg = _cfgs(arch)
    if pattern:
        cfg = cfg.replace(block_pattern=pattern, n_layers=len(pattern))
    return cfg, T.init(cfg, torch.Generator().manual_seed(0))


def _decode_loop(cfg, params, prompts, max_len):
    cache = T.init_cache(cfg, prompts.shape[0], max_len, device="cpu", dtype=torch.float32)
    for i in range(prompts.shape[1]):
        logit, cache = T.decode_step(params, prompts[:, i], cache, i, cfg)
    return logit, cache


@pytest.mark.parametrize("arch,pattern", [
    ("zamba2-1.2b", ("mamba2", "mamba2_attn")),
    ("xlstm-1.3b", ("mlstm", "slstm")),
    ("mixtral-8x22b", None),
])
def test_fused_prefill_matches_decode_loop(arch, pattern):
    cfg, params = _tiny(arch, pattern)
    prompts = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (2, 4))
                               .astype(np.int32))
    ref_logit, ref_cache = _decode_loop(cfg, params, prompts, 8)
    logit, cache = T.prefill(params, prompts, T.init_cache(cfg, 2, 8, device="cpu",
                                                           dtype=torch.float32), cfg)
    np.testing.assert_allclose(logit.numpy(), ref_logit.numpy(), **TOL)
    tok = torch.argmax(logit, -1).to(torch.int32)
    a, _ = T.decode_step(params, tok, cache, 4, cfg)
    b, _ = T.decode_step(params, tok, ref_cache, 4, cfg)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_scheduler_recurrent_prefill_serves_the_decode_loop():
    """The per-token fallback's greedy tokens equal a plain decode loop's,
    for two requests sharing a 2-slot pool, one arriving mid-flight."""
    cfg, params = _tiny("zamba2-1.2b", ("mamba2", "mamba2_attn"))
    sched = Scheduler(cfg, params, slots=2, max_len=12)
    assert not sched.fused
    reqs = make_requests(2, 5, 4, cfg.vocab, stagger=2)
    out = sched.run(reqs)
    for r in reqs:
        seq = torch.from_numpy(np.asarray(r.prompt, np.int32))[None]
        want = []
        logit, cache = _decode_loop(cfg, params, seq, 12)
        for i in range(4):
            tok = torch.argmax(logit, -1).to(torch.int32)
            want.append(int(tok[0]))
            logit, cache = T.decode_step(params, tok, cache, 5 + i, cfg)
        assert out["completions"][r.rid].tokens == want


def test_scheduler_empty_prompt_reuses_slot_with_fresh_state():
    """A recurrent slot must be zeroed when an empty-prompt request reuses
    it: state has no position indexing, so the previous occupant's is not
    masked away like stale K/V."""
    cfg, params = _tiny("xlstm-1.3b", ("mlstm", "slstm"))
    rng = np.random.RandomState(11)
    warm = Request(rid=0, prompt=rng.randint(0, cfg.vocab, (4,)).astype(np.int32), gen=2)
    empty = Request(rid=1, prompt=np.zeros((0,), np.int32), gen=3)
    sched = Scheduler(cfg, params, slots=1, max_len=16)
    reused = sched.run([warm, empty])["completions"][1].tokens
    sched.reset()
    assert sched.run([empty])["completions"][1].tokens == reused


def test_scheduler_sampling_recurrent_prefill_path():
    """The fallback samples its first token from the last prompt logits, and
    a seed reproduces the stream."""
    cfg, params = _tiny("xlstm-1.3b", ("mlstm",))
    reqs = lambda: make_requests(2, 3, 3, cfg.vocab)
    runs = []
    for _ in range(2):
        s = Scheduler(cfg, params, slots=1, max_len=8, temperature=0.7, seed=9)
        assert not s.fused
        runs.append({r: c.tokens for r, c in s.run(reqs())["completions"].items()})
    assert runs[0] == runs[1]


def test_scheduler_refuses_enc_dec():
    cfg = configs.reduced(configs.get("whisper-base"))
    with pytest.raises(NotImplementedError, match="enc-dec"):
        Scheduler(cfg, E.init(cfg, torch.Generator().manual_seed(0)), slots=1, max_len=8)


def test_cli_serves_a_recurrent_arch_and_exits_on_enc_dec(capsys):
    out = serve.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "3", "--gen", "2", "--slots", "2"])
    assert out["generated"] == 4
    with pytest.raises(SystemExit, match="enc-dec"):
        serve.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])


def test_trainer_takes_frames(tmp_path):
    """The launcher trains the enc-dec arch: its batches carry frames."""
    state, history = train.main(["--arch", "whisper-base", "--device", "cpu", "--steps", "3",
                                 "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                                 "--lr", "1e-2", "--ckpt-dir", str(tmp_path / "ck")])
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
