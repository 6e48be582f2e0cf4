"""Port's paged serving engine against the JAX package's.

The port's ``Scheduler(paged=True)`` must return greedy tokens identical to
the JAX ``Scheduler(paged=True)`` on the same parameters and the same
staggered request mix; the port's ``BlockPool`` keeps the allocator's
invariants; ``submit`` names the limit it enforces; the CLI runs in-process
on the CPU.
"""
import jax
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
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.scheduler import Request, Scheduler, sample_tokens
from repro_torch.models import transformer as T
from repro_torch.serving import BlockPool, PoolExhausted

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PCFG = ParallelConfig(remat="none", fsdp_params=False)


@pytest.fixture(scope="module")
def tiny():
    """The JAX paged tests' ``tiny()`` llama: reduced, f32, vocab 64."""
    jcfg = jreduced(jconfigs.get("llama3.2-3b")).replace(
        dtype="float32", param_dtype="float32", vocab=64)
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", vocab=64)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                               device="cpu")


def test_paged_greedy_tokens_identical_to_jax(tiny):
    """The JAX paged engine's test mix: staggered arrivals, an empty prompt,
    chunk 3 (a partial final slice), block 4 (a partial last page), two
    slots so requests queue and slots are reused."""
    jcfg, cfg, jparams, params = tiny
    rng = np.random.RandomState(7)
    spec = [(5, 3, 0), (2, 4, 0), (7, 2, 1), (0, 3, 3)]
    prompts = [rng.randint(0, cfg.vocab, (lp,)).astype(np.int32) for lp, _, _ in spec]
    jreqs = [JRequest(rid=i, prompt=prompts[i], gen=g, arrival=a)
             for i, (_, g, a) in enumerate(spec)]
    reqs = [Request(rid=i, prompt=prompts[i], gen=g, arrival=a)
            for i, (_, g, a) in enumerate(spec)]
    want = JScheduler(jcfg, PCFG, jparams, slots=2, max_len=16, paged=True,
                      block=4, chunk=3).run(jreqs)
    got = Scheduler(cfg, params, slots=2, max_len=16, paged=True, block=4,
                    chunk=3).run(reqs)
    for i, (_, gen, _) in enumerate(spec):
        assert got["completions"][i].tokens == want["completions"][i].tokens, i
        assert len(got["completions"][i].tokens) == gen
    assert got["ticks"] == want["ticks"]
    assert got["pool"] == want["pool"]          # same allocator, same pages
    assert got["pool"]["occupancy"] == 0.0 and got["pool"]["peak_occupancy"] > 0.0


def _check_invariants(pool: BlockPool):
    live = [blk for chain in pool._pages.values() for blk in chain]
    assert len(live) == len(set(live)), "a block is aliased by two chains"
    assert sorted(live + pool._free) == list(range(pool.n_blocks))
    for rid, chain in pool._pages.items():
        assert len(chain) <= pool._reserved[rid]
    assert pool.reserved_blocks <= pool.n_blocks


def test_block_pool_units():
    pool = BlockPool(4, 8)
    assert pool.blocks_needed(1) == 1 and pool.blocks_needed(8) == 1
    assert pool.blocks_needed(9) == 2
    pool.admit(0, 20)                            # reserves 3 of 4
    assert not pool.can_admit(9) and pool.can_admit(8)
    with pytest.raises(PoolExhausted):
        pool.admit(1, 9)
    pool.ensure(0, 5)
    with pytest.raises(PoolExhausted):           # beyond the reservation
        pool.ensure(0, 25)
    rep = pool.report()
    assert rep["live_blocks"] == 1 and rep["reserved_blocks"] == 3
    assert rep["occupancy"] == 0.25
    assert rep["internal_frag"] == pytest.approx(1 - 5 / 8)
    pool.free(0)
    assert pool.report()["occupancy"] == 0.0
    assert pool.report()["peak_occupancy"] == 0.25
    with pytest.raises(ValueError):
        BlockPool(0, 8)


def test_block_pool_random_interleavings():
    """Seeded admit/grow/free interleavings: chains never alias, free +
    live partitions the pool, reservations never oversubscribe it, and the
    table row mirrors the chain with a -1 tail."""
    rng = np.random.RandomState(0)
    for _ in range(40):
        pool, live, rid = BlockPool(16, 4), {}, 0
        for _ in range(rng.randint(1, 60)):
            kind, value = ["admit", "grow", "free"][rng.randint(3)], int(rng.randint(10 ** 6))
            if kind == "admit":
                total = 1 + value % 64
                if pool.can_admit(total):
                    pool.admit(rid, total)
                    live[rid] = [0, total]
                else:
                    with pytest.raises(PoolExhausted):
                        pool.admit(rid, total)
                rid += 1
            elif kind == "grow" and live:
                r = sorted(live)[value % len(live)]
                cur, total = live[r]
                tokens = min(cur + 1 + value % 4, total)
                chain = pool.ensure(r, tokens)
                live[r][0] = tokens
                row = pool.table(r, pool.n_blocks)
                assert list(row[:len(chain)]) == chain and all(row[len(chain):] == -1)
            elif kind == "free" and live:
                r = sorted(live)[value % len(live)]
                pool.free(r)
                del live[r]
            _check_invariants(pool)
        for r in sorted(live):
            pool.free(r)
        assert pool.live_blocks == 0 and pool.free_blocks == pool.n_blocks


def test_submit_validates_with_named_limits(tiny):
    _, cfg, _, params = tiny
    pg = Scheduler(cfg, params, slots=1, max_len=64, paged=True, block=4,
                   pool_blocks=8, chunk=4)
    with pytest.raises(ValueError, match=r"pool capacity is 8 blocks"):
        pg.submit(Request(rid=2, prompt=np.zeros(40, np.int32), gen=8))
    with pytest.raises(ValueError, match=r"block-table width cap max_len=64"):
        pg.submit(Request(rid=3, prompt=np.zeros(60, np.int32), gen=8))
    with pytest.raises(ValueError, match="gen >= 1"):
        pg.submit(Request(rid=1, prompt=np.zeros(2, np.int32), gen=0))
    pg.submit(Request(rid=4, prompt=np.zeros(3, np.int32), gen=2))
    assert list(pg.run()["completions"]) == [4]


def test_unported_engine_raises_naming_the_roadmap(tiny):
    """The end-aligned engine is ported with its recurrent per-token prefill
    fallback (``test_torch_families.py``), and so are the recurrent blocks
    and the serve engine under a mesh ctx (``test_torch_serve_mesh.py``,
    ``test_torch_engines_mesh.py``), the sequence-parallel residual
    (``test_torch_train_mesh.py``) and an end-aligned cache whose length
    the model axis does not split: it is held whole on every rank, as JAX
    holds it, and the scheduler takes any ``max_len`` and ``bucket``.  What
    is left raises before any collective: ``sequence_parallel`` with
    ``dp_over_model``, whose residual spec would name ``model`` twice (JAX
    refuses it too)."""
    from repro_torch.config import ParallelConfig as PortParallelConfig
    from repro_torch.config import SSMConfig
    from repro_torch.core.mesh import AbstractMesh
    from repro_torch.parallel.sharding import make_ctx
    _, cfg, _, params = tiny
    recurrent = cfg.replace(block_pattern=("mamba2",), ssm=SSMConfig(d_state=8, head_dim=16))
    assert not Scheduler(recurrent, params, slots=1, max_len=8).fused
    mesh = AbstractMesh((1, 2), ("data", "model"))
    ctx = make_ctx(mesh, PortParallelConfig(fsdp_params=False))
    both = make_ctx(mesh, PortParallelConfig(fsdp_params=False, sequence_parallel=True,
                                             dp_over_model=True))
    with pytest.raises(ValueError, match="sequence_parallel with dp_over_model"):
        T.forward(params, torch.zeros(1, 4, dtype=torch.int32), cfg, ctx=both)
    k, v = T.init_cache(cfg, 1, 9, device="cpu", ctx=ctx)[0]
    assert k.shape == v.shape == (1, 9, cfg.n_kv_heads, cfg.hd)
    assert k.cache_spec[1] is None                        # the length dim: whole
    assert T.init_cache(cfg, 1, 8, device="cpu", ctx=ctx)[0][0].shape[1] == 4
    sched = Scheduler(cfg, params, slots=2, max_len=9, bucket=3, ctx=ctx)
    assert sched.cache[0][0].shape[1] == 9
    # the paged arenas are whole on every rank; the recurrent state splits
    assert T.init_cache(recurrent, 2, 9, device="cpu", ctx=ctx)[0]["mamba"]["ssm"].shape[1] == \
        T.init_cache(recurrent, 2, 9, device="cpu")[0]["mamba"]["ssm"].shape[1] // 2


def test_sampling_is_seeded_and_top_p_narrows_to_greedy():
    logits = torch.from_numpy(np.random.RandomState(8).randn(3, 50).astype(np.float32))
    greedy = torch.argmax(logits, -1).to(torch.int32)
    assert torch.equal(sample_tokens(logits, torch.Generator(), 0.0), greedy)
    # a nucleus smaller than the top token's mass keeps only the top token
    assert torch.equal(sample_tokens(logits, torch.Generator(), 1.0, top_p=1e-6), greedy)
    a = sample_tokens(logits, torch.Generator().manual_seed(3), 1.5, top_p=0.9)
    b = sample_tokens(logits, torch.Generator().manual_seed(3), 1.5, top_p=0.9)
    assert torch.equal(a, b)


def test_serve_cli_in_process(capsys):
    out = serve.main(["--device", "cpu", "--reduced", "--paged", "--requests", "3",
                      "--prompt-len", "9", "--gen", "3", "--slots", "2",
                      "--chunk", "4", "--block", "4"])
    assert sorted(out["completions"]) == [0, 1, 2]
    assert all(len(c.tokens) == 3 for c in out["completions"].values())
    text = capsys.readouterr().out
    assert "tok/s" in text and "peak occupancy" in text
    with pytest.raises(SystemExit):                       # a named argument error
        serve.main(["--device", "cpu", "--reduced", "--paged", "--chunk", "0"])
