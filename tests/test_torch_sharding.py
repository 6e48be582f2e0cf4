"""The port's layout machinery against the JAX package's: the sharding rules
(``parallel/sharding.py``) and the cost-driven planner
(``parallel/planner.py``).

Specs: every arch's abstract parameter tree (JAX's ``eval_shape``), with
the layers unstacked as the port holds them, goes through the port's
``param_specs`` / ``scatter_specs`` / ``opt_specs`` and through JAX's on
``compat.abstract_mesh``: the specs and the dropped-partition reports must
be equal.  Against JAX's own stacked tree a layer leaf's parameter spec is
the JAX spec without its leading None.  (The scatter layouts differ there
by design: JAX may put the ZeRO scatter on the stacking dim, which the
port's unstacked layers do not have.)

Planner: ``plan_search`` for every arch and both kinds on the reference's
meshes, with the reference's constants passed to both sides, must give the
same labels in the same order, and costs and memory equal to a relative
1e-9.  Then the in-process checks of ``tests/test_planner.py`` on the
port's module.
"""
import dataclasses
import functools
import warnings

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.config import ParallelConfig as JParallelConfig
from repro.core import costmodel as rm
from repro.core.compat import abstract_mesh
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.parallel import planner as jplanner
from repro.parallel import sharding as jsharding
from repro_torch import configs
from repro_torch.config import ParallelConfig
from repro_torch.core import costmodel
from repro_torch.core.mesh import AbstractMesh, P
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.models import transformer as T
from repro_torch.models.moe import MeshCtx
from repro_torch.parallel import planner
from repro_torch.parallel.sharding import (dropped_partition_report, make_ctx, opt_specs,
                                           param_specs, reset_dropped_partitions,
                                           sanitize_spec, scatter_specs)
from repro_torch.tree import leaves_with_path

STACKED = ("layers", "enc_layers", "dec_layers")
MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
LAYOUTS = [dict(fsdp_params=False), dict(fsdp_params=True),
           dict(fsdp_params=False, dp_over_model=True),
           dict(fsdp_params=True, dp_over_model=True),
           dict(fsdp_params=True, fsdp_pod=True),
           dict(moe_a2a_ep=True), dict(engine_replicate=True)]
# the reference's machine, passed to both planners
JAX_HW = dict(hbm=rm.HBM_PER_CHIP, link=costmodel.LinkClass(rm.ICI.t_s, rm.ICI.t_w),
              peak_flops=rm.PEAK_FLOPS_BF16, hbm_bw=rm.HBM_BW)
REL = 1e-9


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    cfg = jconfigs.get(arch)
    init = JE.init if cfg.enc_dec else JT.init
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


def _unstacked(jtree, cfg, leaf):
    """The port's layout of a JAX parameter tree, with ``leaf(shape)`` as
    leaves: every stacked container unstacked into a list of per-layer
    trees (period j, kind i -> layer j * len(pattern) + i).  A rule does not
    depend on the layer's index, so two periods stand for all of them."""
    out = {}
    for k, v in jtree.items():
        if k == "layers":
            out[k] = [jax.tree.map(lambda a: leaf(a.shape[1:]), v[i])
                      for _ in range(min(cfg.n_periods, 2)) for i in range(len(v))]
        elif k in STACKED:
            n = min(jax.tree.leaves(v)[0].shape[0], 2)
            out[k] = [jax.tree.map(lambda a: leaf(a.shape[1:]), v) for _ in range(n)]
        else:
            out[k] = jax.tree.map(lambda a: leaf(a.shape), v)
    return out


def _port_tree(jtree, cfg):
    return _unstacked(jtree, cfg, lambda shape: torch.empty(shape, device="meta"))


def _jax_unstacked(jtree, cfg):
    return _unstacked(jtree, cfg, lambda shape: jax.ShapeDtypeStruct(shape, "float32"))


def _jax_key(path, cfg):
    """The JAX leaf name and stacked dim offset of a port leaf path."""
    names = [str(k) for k in path]
    if names[0] == "layers":
        return "/".join(["layers", str(int(names[1]) % len(cfg.block_pattern))] + names[2:]), 1
    if names[0] in STACKED:
        return "/".join([names[0]] + names[2:]), 1
    return "/".join(names), 0


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): s
            for path, s in flat}


def _compare(port_specs, jax_specs, cfg, stacked=True):
    n = 0
    for path, spec in leaves_with_path(port_specs):
        key, off = _jax_key(path, cfg) if stacked else ("/".join(map(str, path)), 0)
        want = tuple(jax_specs[key])
        assert isinstance(spec, P)
        assert tuple(spec) == want[off:], (key, spec, want)
        assert want[:off] == (None,) * off
        n += 1
    return n


def _report(fn):
    reset_dropped_partitions()
    jsharding.reset_dropped_partitions()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fn()
    return out


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_specs_equal_to_jax(arch, mesh_shape, axes):
    """param_specs, scatter_specs and opt_specs for every arch, mesh and
    layout, and the dropped-partition reports, modulo the stacked None."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    jtree = _jax_abstract(arch)
    ptree, jflat = _port_tree(jtree, cfg), _jax_unstacked(jtree, cfg)
    jmesh, mesh = abstract_mesh(mesh_shape, axes), AbstractMesh(mesh_shape, axes)
    for kw in LAYOUTS:
        jctx = jsharding.make_ctx(jmesh, JParallelConfig(**kw))
        ctx = make_ctx(mesh, ParallelConfig(**kw))
        assert {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx) if f.name != "mesh"} \
            == {f.name: getattr(jctx, f.name) for f in dataclasses.fields(jctx) if f.name != "mesh"}
        assert ctx.model_size == jctx.model_size and ctx.all_axes == jctx.all_axes

        def both():
            got = (param_specs(ptree, cfg, ctx), scatter_specs(ptree, cfg, ctx))
            want = (jsharding.param_specs(jflat, jcfg, jctx),
                    jsharding.scatter_specs(jflat, jcfg, jctx))
            return got, want, dropped_partition_report(), jsharding.dropped_partition_report()

        (pspec, sspec), (jpspec, jsspec), rep, jrep = _report(both)
        n = _compare(pspec, _jax_specs(jpspec), cfg, stacked=False)
        assert _compare(sspec, _jax_specs(jsspec), cfg, stacked=False) == n > 0
        norm = lambda rs: sorted((r["leaf"], r["dim"], tuple(r["shape"]), tuple(r["axes"]),
                                  r["shard"]) for r in rs)
        assert norm(rep) == norm(jrep)
        # the reference's stacked tree: the same parameter specs, modulo the
        # leading None of a stacked leaf
        jstacked = _report(lambda: jsharding.param_specs(jtree, jcfg, jctx))
        assert _compare(pspec, _jax_specs(jstacked), cfg) == n
        o = opt_specs(pspec, sspec)
        assert o["m"] is sspec and o["v"] is sspec and o["step"] == P()


def test_sanitize_spec_reports_dropped_partitions():
    mesh = AbstractMesh((8, 1), ("data", "model"))
    reset_dropped_partitions()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        kept = sanitize_spec(P("data"), (64,), mesh, path="ok/leaf")
        dropped = sanitize_spec(P("data"), (7,), mesh, path="bad/leaf")
        quiet = sanitize_spec(P("data"), (7,), mesh, path="quiet/leaf", record=False)
    assert kept == P("data") and dropped == P(None) and quiet == P(None)
    rep = dropped_partition_report()
    assert [r["leaf"] for r in rep] == ["bad/leaf"]
    assert rep[0]["axes"] == ("data",) and rep[0]["shard"] == 8
    reset_dropped_partitions()
    assert dropped_partition_report() == []


def _ctx8(fsdp):
    mesh = AbstractMesh((8, 1), ("data", "model"))
    return MeshCtx(mesh=mesh, batch_axes=("data",), model_axis="model", fsdp_axes=fsdp)


def test_scatter_specs_adds_data_axis():
    cfg = configs.reduced(configs.get("llama3.2-3b"))
    params = T.init(cfg, None)
    ctx = _ctx8(())
    sspec, pspec = scatter_specs(params, cfg, ctx), param_specs(params, cfg, ctx)
    changed = 0
    for (_, s), (_, p_), (_, leaf) in zip(leaves_with_path(sspec), leaves_with_path(pspec),
                                          leaves_with_path(params)):
        if s != p_:
            changed += 1
            hit = [i for i, a in enumerate(s) if a == "data"]
            assert hit and leaf.shape[hit[0]] % 8 == 0, (s, leaf.shape)
    assert changed > 0


def test_scatter_specs_noop_on_fsdp_sharded_leaves():
    """FSDP storage already scatters the matrices: only the FSDP-replicated
    stragglers (norm scales) gain a scatter axis."""
    cfg = configs.reduced(configs.get("llama3.2-3b"))
    params = T.init(cfg, None)
    ctx = _ctx8(("data",))
    for (_, s), (_, p_) in zip(leaves_with_path(scatter_specs(params, cfg, ctx)),
                               leaves_with_path(param_specs(params, cfg, ctx))):
        if "data" in tuple(p_):
            assert s == p_, (s, p_)


def test_opt_specs_scatter_layout():
    pspec = {"w": P(None, "model")}
    sspec = {"w": P("data", "model")}
    assert opt_specs(pspec)["m"] is pspec
    o = opt_specs(pspec, sspec)
    assert o["m"] is sspec and o["v"] is sspec and o["step"] == P()


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------
def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (str, bool)):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=REL, abs=0.0), (got, want)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_plan_search_equal_to_jax(arch, kind):
    """Every arch, both kinds, on (16, 16) and (2, 16, 16) at the production
    train / decode shapes, the reference's constants on both sides."""
    from repro.config import SHAPES
    shape = SHAPES["train_4k" if kind == "train" else "decode_32k"]
    for mesh_shape in ((16, 16), (2, 16, 16)):
        got = planner.plan_search(configs.get(arch), mesh_shape, shape.global_batch,
                                  shape.seq_len, kind, **JAX_HW)
        want = jplanner.plan_search(jconfigs.get(arch), mesh_shape, shape.global_batch,
                                    shape.seq_len, kind)
        assert [r.plan.label() for r in got] == [r.plan.label() for r in want]
        for g, w in zip(got, want):
            assert dataclasses.asdict(g.plan) == dataclasses.asdict(w.plan)
            assert dataclasses.asdict(g.plan.to_pcfg()) == dataclasses.asdict(w.plan.to_pcfg())
            assert g.feasible == w.feasible
            _same(g.cost, w.cost)
            _same(g.memory, w.memory)
        assert planner.best_plan(got).label() == jplanner.best_plan(want).label()
        assert planner.format_plan_table(got) == jplanner.format_plan_table(want)


def test_plan_search_deterministic():
    cfg = configs.get("llama3.2-3b")
    a = planner.plan_search(cfg, (16, 16), 256, 4096, "train")
    b = planner.plan_search(cfg, (16, 16), 256, 4096, "train")
    assert [r.plan.label() for r in a] == [r.plan.label() for r in b]
    assert [r.total_s for r in a] == [r.total_s for r in b]
    assert a and a[0].feasible, "no feasible plan for the 3B cell"


def test_plan_search_more_hbm_superset():
    """More HBM per card: the feasible set only grows."""
    cfg = configs.get("llama3.2-3b")
    feas = lambda hbm: {r.plan.label() for r in
                        planner.plan_search(cfg, (16, 16), 256, 4096, "train", hbm=hbm)
                        if r.feasible}
    small, big = feas(8 * 2**30), feas(64 * 2**30)
    assert small <= big and len(big) > len(small)


@pytest.mark.parametrize("p", [4, 16, 64])
def test_zero_beats_allreduce_on_larger_meshes(p):
    """On a pure-DP mesh the ZeRO step's predicted communication and
    optimizer traffic undercut the all-reduce step's, and the gap widens
    with the mesh (H100 constants)."""
    cfg = configs.get("llama3.2-3b")
    pc = cfg.param_counts()

    def cost(grad, q):
        return costmodel.train_step_cost(
            pc["active"], pc["total"], tokens=4096.0 * q, chips=q, tp=1, dp=q,
            fsdp_shard=1, grad=grad, batch_local=1, seq=4096, d_model=cfg.d_model,
            n_layers=cfg.n_layers, grad_bytes=4)

    ar, z = cost("all_reduce", p), cost("reduce_scatter_zero", p)
    assert z["grad_s"] < ar["grad_s"] and z["update_s"] < ar["update_s"]
    assert z["total_s"] < ar["total_s"]
    ar2, z2 = cost("all_reduce", 2 * p), cost("reduce_scatter_zero", 2 * p)
    assert (ar2["update_s"] - z2["update_s"]) >= (ar["update_s"] - z["update_s"]) * 0.99


def test_zero_memory_scales_down_with_dp():
    prev = None
    for dp in (2, 4, 8, 16):
        z = costmodel.train_memory_bytes(1e9, dp=dp, grad="reduce_scatter_zero")
        ar = costmodel.train_memory_bytes(1e9, dp=dp, grad="all_reduce")
        assert z["opt"] * dp == pytest.approx(ar["opt"])
        assert z["grads"] * dp == pytest.approx(ar["grads"])
        if prev is not None:
            assert z["total"] < prev
        prev = z["total"]


def test_default_plan_properties_with_the_references_constants():
    """On the reference's machine the port's default plans are JAX's: the
    train cell a memory-feasible ZeRO point with full remat and f32
    moments, serving TP-resident for 3B and FSDP-sharded for 405B."""
    hw = {k: v for k, v in JAX_HW.items()}
    plan = planner.default_plan("llama3.2-3b", "train", **hw)
    assert plan.label() == jplanner.default_plan("llama3.2-3b", "train").label()
    assert plan.grad == "reduce_scatter_zero" and plan.remat == "full"
    assert plan.opt_state_dtype == "float32"
    assert plan.to_pcfg().grad_reduce == "reduce_scatter_zero"
    assert planner.default_plan("llama3.2-3b", "decode", **hw).fsdp_axes == ()
    assert planner.default_plan("llama3-405b", "decode", **hw).fsdp_axes
    # and on the port's own (80 GB) cards the serving rule holds too
    assert planner.default_plan("llama3.2-3b", "decode").fsdp_axes == ()


def test_plan_lattice_head_is_runnable_when_nothing_fits():
    cfg = configs.get("llama3-405b")
    ranked = planner.plan_search(cfg, (16, 16), 256, 4096, "train", hbm=rm.HBM_PER_CHIP)
    assert ranked
    if not ranked[0].feasible:
        assert ranked[0].memory["total"] == min(r.memory["total"] for r in ranked
                                                if not r.feasible)


def test_production_mesh_needs_its_ranks():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
