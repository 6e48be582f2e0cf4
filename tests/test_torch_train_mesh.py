"""The port's trainer on a mesh of CPU ranks against the JAX package's
single-device trainer: the eight dense layouts, the ZeRO step, the sharded
init and the launcher with ``--ranks``.

JAX initialises the train state, ``repro_torch.convert`` carries it over,
and each rank keeps its blocks under ``train_state_shardings`` (the
reference's ``shard_params``).  The same numpy token batches go through
JAX's jitted single-device step and, split over the batch axes, through
the port's step on 4 ranks of the mesh (2, 2): every combination of FSDP
on / off, tensor parallelism or ``dp_over_model``, and the all-reduce or
the ZeRO step.  Three steps must follow JAX's trajectory (loss, gradient
norm and rate per step, the parameters normwise after the steps): f32
gradients to 1e-4, bf16 gradients to 2e-2, as
``test_torch_train.py::test_train_trajectory_matches_jax`` holds the
single-device step.  The ZeRO step must match the port's all-reduce step.
All the port's steps run in one module-scoped launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.parallel import steps as JS
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core.mesh import AbstractMesh, assemble, launch, local_block
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import make_ctx, shard_params
from repro_torch.tree import leaves, tree_map

MESH = (2, 2)
STEPS, BATCH, SEQ = 3, 4, 16
TOL = {"float32": 1e-4, "bfloat16": 2e-2}              # by gradient dtype
LAYOUTS = {f"{'fsdp' if f else 'nofsdp'}-{'dpom' if d else 'tp'}-{'zero' if z else 'ar'}":
           dict(fsdp_params=f, dp_over_model=d,
                grad_reduce="reduce_scatter_zero" if z else "all_reduce")
           for f in (False, True) for d in (False, True) for z in (False, True)}
# extra runs: the selective-recompute policy and the chunked loss under TP
EXTRA = {"fsdp-tp-ar-dots": dict(fsdp_params=True, remat="dots"),
         "nofsdp-tp-zero-chunk": dict(fsdp_params=False, grad_reduce="reduce_scatter_zero",
                                      logit_chunk=6)}
TCFG = dict(lr=3e-3, warmup_steps=2, total_steps=8)


def _cfgs():
    return (jreduced(jconfigs.get("llama3.2-3b")).replace(dtype="float32", n_layers=2),
            configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", n_layers=2))


def _tokens():
    r = np.random.RandomState(7)
    return [r.randint(0, 512, (BATCH, SEQ)).astype(np.int32) for _ in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(cfg, pcfg, tcfg, jstate, toks, mesh):
    """One layout on this rank: STEPS steps from JAX's state; per-step
    metrics and, on rank 0, the parameters assembled."""
    ctx = make_ctx(mesh, pcfg)
    full = train_state_from_jax(jstate, cfg, device="cpu")
    specs = S.train_state_shardings(cfg, pcfg, ctx, full)
    state = tree_map(lambda x, s: local_block(x, s, mesh).clone(), full, specs)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(state["params"]), leaves(shard_params(full["params"], cfg, ctx))))
    step = S.make_train_step(cfg, pcfg, tcfg, ctx)
    i, n = mesh.index(ctx.batch_axes), mesh.size(ctx.batch_axes)
    rows = BATCH // n
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": torch.from_numpy(t[i * rows:(i + 1) * rows])})
        metrics.append({k: float(v) for k, v in m.items()})
    params = [assemble(x, s, mesh) for x, s in zip(leaves(state["params"]),
                                                    leaves(specs["params"]))]
    return {"metrics": metrics, "params": params if mesh.rank == 0 else None}


def _sharded_init(cfg, mesh):
    """The port's own init on the ranks, assembled, for two layouts (ZeRO
    with FSDP and an f32 master copy; TP with all-reduce)."""
    out = {}
    for name, pcfg in {"zero-fsdp-master": ParallelConfig(
            fsdp_params=True, grad_reduce="reduce_scatter_zero", master_weights=True),
            "tp-ar": ParallelConfig(fsdp_params=False)}.items():
        ctx = make_ctx(mesh, pcfg)
        state = S.init_train_state(torch.Generator().manual_seed(3), cfg, pcfg, ctx)
        specs = S.train_state_shardings(cfg, pcfg, ctx, S.abstract_train_state(cfg, pcfg))
        # bf16 leaves widened (exactly): a result crosses to the test as numpy
        out[name] = [assemble(x, s, mesh).float() if x.dtype == torch.bfloat16 else
                     assemble(x, s, mesh) for x, s in zip(leaves(state), leaves(specs))]
    return out


def _ranks(device, jstates, toks):
    _, cfg = _cfgs()
    mesh = make_local_mesh(2)
    tcfg = TrainConfig(**TCFG)
    res = {}
    for gdt, jstate in jstates.items():
        for name, kw in LAYOUTS.items():
            res[(gdt, name)] = _run(cfg, ParallelConfig(grad_dtype=gdt, **kw), tcfg, jstate,
                                    toks, mesh)
    for name, kw in EXTRA.items():
        res[("float32", name)] = _run(cfg, ParallelConfig(grad_dtype="float32", **kw), tcfg,
                                      jstates["float32"], toks, mesh)
    res["init"] = _sharded_init(cfg, mesh)
    return res


def _jax_trajectory(jcfg, gdt, toks, **pkw):
    jp = jconfig.ParallelConfig(fsdp_params=False, grad_dtype=gdt, **pkw)
    jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jp)
    init = _np(jstate)
    jstep = jax.jit(JS.make_train_step(jcfg, jp, jconfig.TrainConfig(**TCFG), None))
    metrics = []
    for t in toks:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, _np(jstate)


@pytest.fixture(scope="module")
def runs():
    jcfg, _ = _cfgs()
    toks = _tokens()
    jax_runs = {gdt: _jax_trajectory(jcfg, gdt, toks) for gdt in ("float32", "bfloat16")}
    jax_runs["chunk"] = _jax_trajectory(jcfg, "float32", toks, logit_chunk=6)
    ranks = launch(4, _ranks, {g: jax_runs[g][0] for g in ("float32", "bfloat16")}, toks,
                   device="cpu", timeout=600)
    return jax_runs, ranks[0]


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_trajectory(run, jax_run, tol):
    _, cfg = _cfgs()
    _, jmetrics, jfinal = jax_run
    for m, jm in zip(run["metrics"], jmetrics):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=tol)
        assert m["aux"] == jm["aux"] == 0.0
    want = leaves(train_state_from_jax(jfinal, cfg, device="cpu")["params"])
    assert len(run["params"]) == len(want)
    errs = [_normwise(g, w.numpy()) for g, w in zip(run["params"], want)]
    assert max(errs) <= tol, errs


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_follows_the_jax_trajectory(runs, layout, gdt):
    jax_runs, ranks = runs
    _check_trajectory(ranks[(gdt, layout)], jax_runs[gdt], TOL[gdt])


@pytest.mark.parametrize("name", list(EXTRA))
def test_dots_remat_and_chunked_loss_follow_the_jax_trajectory(runs, name):
    """Selective recompute (the collectives re-issued in the backward) and
    the sequence-chunked vocab-parallel loss."""
    jax_runs, ranks = runs
    want = jax_runs["chunk"] if "chunk" in name else jax_runs["float32"]
    _check_trajectory(ranks[("float32", name)], want, TOL["float32"])


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", [k for k in LAYOUTS if k.endswith("-zero")])
def test_zero_step_matches_the_all_reduce_step(runs, layout, gdt):
    """The ZeRO step against the port's all-reduce step in the same layout:
    the same gradients, summed over the same ranks in another order (a
    reduce-scatter, then an all-reduce over the rest).  f32 gradients: the
    losses and norms agree to 1e-6, the parameters normwise to 1e-6; bf16
    gradients round each partial sum to bf16, so the parameters are held
    to one bf16 rounding (2**-8)."""
    _, ranks = runs
    zero, ar = ranks[(gdt, layout)], ranks[(gdt, layout[:-len("zero")] + "ar")]
    for m, n in zip(zero["metrics"], ar["metrics"]):
        np.testing.assert_allclose(m["loss"], n["loss"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], n["grad_norm"], rtol=1e-6)
    bound = 1e-6 if gdt == "float32" else 2.0 ** -8
    assert max(_normwise(a, b) for a, b in zip(zero["params"], ar["params"])) <= bound


@pytest.mark.parametrize("name", ["zero-fsdp-master", "tp-ar"])
def test_sharded_init_equals_the_single_rank_init(runs, name):
    """Drawn leaf by leaf and cut to blocks at once, the state assembles to
    the single-rank ``init_train_state``, bit for bit."""
    _, ranks = runs
    _, cfg = _cfgs()
    pcfg = ParallelConfig(fsdp_params=True, grad_reduce="reduce_scatter_zero",
                          master_weights=True) if name != "tp-ar" else ParallelConfig()
    want = leaves(S.init_train_state(torch.Generator().manual_seed(3), cfg, pcfg))
    got = ranks["init"][name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.float() if w.dtype == torch.bfloat16 else w
        np.testing.assert_array_equal(g, w.numpy())


def test_launcher_on_four_ranks_recovers_and_its_checkpoint_restores_anywhere(tmp_path,
                                                                             capsys):
    """``--ranks 4 --model-parallel 2 --plan auto --steps 8 --ckpt-every 3
    --inject-fault-at 5`` prints the picked plan and OK.  Its step-6
    checkpoint restores on one rank (the same leaves through JAX's
    ``restore_checkpoint``), and one rank resuming from it reaches the four
    ranks' final state."""
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--ranks", "4", "--model-parallel", "2", "--plan", "auto",
            "--steps", "8", "--ckpt-every", "3", "--ckpt-dir", d]
    states, history = launcher.main(argv + ["--inject-fault-at", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert "OK" in lines and any(ln.startswith("plan_search picked:") for ln in lines)
    # the fault at step 5 restarts every rank from the step-3 checkpoint; a
    # straggler verdict under a loaded host may restart once more later
    steps = [h["step"] for h in history]
    assert steps[:7] == [0, 1, 2, 3, 4, 3, 4] and steps[-1] == 7
    assert ckpt.latest_step(d) == 6

    job = launcher.make_job(launcher.parse_args(argv))
    cfg, pcfg = job.cfg, job.pcfg
    like = S.abstract_train_state(cfg, pcfg)
    one = ckpt.restore_checkpoint(d, 6, like, device="cpu")
    jtree = jckpt.restore_checkpoint(d, 6, jax.tree.map(
        lambda t: np.zeros(t.shape, np.float32), like, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(jtree), leaves(one)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    # one rank resumes the four ranks' run from step 6 and ends where they did
    out = launcher.train_rank("cpu", job)
    assert [h["step"] for h in out["history"]] == [6, 7]
    ctx = make_ctx(AbstractMesh((2, 2), ("data", "model")), pcfg)
    specs = S.train_state_shardings(cfg, pcfg, ctx, like)
    for rank, blocks in enumerate(states):
        coords = dict(zip(("data", "model"), np.unravel_index(rank, (2, 2))))
        for spec, full, got in zip(leaves(specs), leaves(out["state"]), leaves(blocks)):
            want = full.float().numpy()
            for dim, part in enumerate(spec):
                axes = () if part is None else (part if isinstance(part, tuple) else (part,))
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * 2 + int(coords[a]), n * 2
                blk = want.shape[dim] // n
                want = np.take(want, range(idx * blk, (idx + 1) * blk), axis=dim)
            # bf16 compute: the ranks and the one process sum in other orders
            assert _normwise(got, want) <= 2e-2 if want.any() else not got.any()
