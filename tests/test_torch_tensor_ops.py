"""The port's tensor-parallel algebra against the JAX package's single-device
functions: the differentiable Table-1 collectives (``core/dseq.py``), the
FooPar TP products (``core/tensor_ops.py``), the TP MLP (``_mlp_foopar``)
and attention under a mesh ctx (the sequence-sharded region and
``_sdpa_manual``).

Inputs are made from numpy seeds.  All the port's checks run in one launch
of 4 CPU ranks, on the meshes (2, 2) (TP over 2, with a data axis) and
(1, 4) (TP over 4); each rank returns its output and gradient blocks, and
the tests hold them to the matching blocks of JAX's ``jnp.matmul`` /
``L.mlp`` / ``L.attention`` and ``jax.grad`` at f32 ``rtol=1e-4,
atol=1e-5``.  JAX's own manual-attention oracle is red on jax 0.9.0
(``test_core_algebra.py::test_manual_attention``), so attention is held to
the single-device ``L.attention``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.core import costmodel as rm
from repro.core import tensor_ops as jops
from repro.models import layers as JL
from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import costmodel
from repro_torch.core import tensor_ops as ops
from repro_torch.core.dseq import (all_gather_dim, all_gather_whole, all_to_all_dim, copy_d,
                                   reduce_scatter_dim, reduce_sum, split_dim)
from repro_torch.core.mesh import P, ProcessMesh, launch, local_block
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import make_ctx, param_specs

TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MLP_CFG = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
               d_ff=64, vocab=64, dtype="float32")
ATTN_CFGS = {
    "qk_norm": dict(name="a", family="dense", n_layers=1, d_model=32, n_heads=4,
                    n_kv_heads=2, head_dim=8, d_ff=64, vocab=64, dtype="float32",
                    qk_norm=True),
    "window_2d_rope": dict(name="b", family="dense", n_layers=1, d_model=32, n_heads=4,
                           n_kv_heads=2, head_dim=8, d_ff=64, vocab=64, dtype="float32",
                           window=3, rope_fraction=0.5),
}
# the attention layouts: TP (the Ulysses region, and the same with the
# manual-attention flag), FSDP + TP, and pure DP over both axes
ATTN_LAYOUTS = {"tp": dict(fsdp_params=False), "tp_manual": dict(fsdp_params=False,
                                                                 manual_attention=True),
                "fsdp_tp": dict(fsdp_params=True), "dp_over_model": dict(fsdp_params=False,
                                                                        dp_over_model=True)}


def _inputs():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype(np.float32)
    mlp = {"w_gate": f(32, 64) / 6, "w_up": f(32, 64) / 6, "w_down": f(64, 32) / 8}
    attn = {"wq": f(32, 32) / 6, "wk": f(32, 16) / 6, "wv": f(32, 16) / 6, "wo": f(32, 32) / 6,
            "q_norm": {"scale": 1 + f(8) / 4}, "k_norm": {"scale": 1 + f(8) / 4}}
    return {"x": f(3, 4, 16), "w": f(16, 8), "cot": f(3, 4, 8), "hx": f(4, 8, 32),
            "hcot": f(4, 8, 32), "mlp": mlp, "attn": attn, "coll": f(4, 8, 12)}


def _grad_blocks(fn, args):
    """Run ``fn`` on leaf copies of ``args`` that require grad; return the
    output and the gradients of sum(output * cotangent) taken by ``fn``."""
    live = [a.detach().clone().requires_grad_(True) for a in args]
    out, cot = fn(*live)
    grads = torch.autograd.grad((out * cot).sum(), live, allow_unused=True,
                                materialize_grads=True)
    return out.detach(), [g.detach() for g in grads]


def _collectives(mesh, x):
    """Each differentiable collective's gradient against its transpose,
    computed without autograd, on this rank's block ``x`` (4, 8, 12)."""
    M = "model"
    c = x.flip(0) + 1.0
    out = {}
    _, (g,) = _grad_blocks(lambda a: (all_to_all_dim(a, M, 1, 2, mesh), all_to_all_dim(
        c, M, 1, 2, mesh)), [x])
    out["all_to_all"] = (g - all_to_all_dim(all_to_all_dim(c, M, 1, 2, mesh), M, 2, 1,
                                            mesh)).abs().max()
    _, (g,) = _grad_blocks(lambda a: (all_gather_dim(a, M, 2, mesh), all_gather_dim(
        c, M, 2, mesh)), [x])
    want = mesh.reduce_scatter_sum(all_gather_dim(c, M, 2, mesh).movedim(2, 0), M).movedim(0, 2)
    out["all_gather"] = (g - want).abs().max()
    _, (g,) = _grad_blocks(lambda a: (copy_d(a, M, mesh), c), [x])
    out["copy"] = (g - mesh.all_reduce(c, "sum", M)).abs().max()
    _, (g,) = _grad_blocks(lambda a: (reduce_sum(a, M, mesh), c), [x])
    out["reduce_sum"] = (g - c).abs().max()
    # the sequence-parallel pair and the way into and out of a replicated block
    rs = reduce_scatter_dim(c, M, 2, mesh)
    _, (g,) = _grad_blocks(lambda a: (reduce_scatter_dim(a, M, 2, mesh), rs), [x])
    out["reduce_scatter"] = (g - all_gather_dim(rs, M, 2, mesh)).abs().max()
    sp = split_dim(c, M, 2, mesh)
    _, (g,) = _grad_blocks(lambda a: (split_dim(a, M, 2, mesh), sp), [x])
    out["split"] = (g - all_gather_dim(sp, M, 2, mesh)).abs().max()
    _, (g,) = _grad_blocks(lambda a: (all_gather_whole(a, M, 2, mesh),
                                      all_gather_dim(c, M, 2, mesh)), [x])
    out["gather_whole"] = (g - c).abs().max()
    # the forward values
    out["all_to_all_fwd"] = all_to_all_dim(x, M, 1, 2, mesh)
    out["all_gather_fwd"] = all_gather_dim(x, M, 2, mesh)
    out["reduce_scatter_fwd"] = reduce_scatter_dim(x, M, 2, mesh)
    out["split_fwd"] = split_dim(x, M, 2, mesh)
    return out


def _ranks(device, inp):
    t = lambda a: torch.from_numpy(a)
    res = {}
    for name, shape in MESHES.items():
        mesh = ProcessMesh(shape, ("data", "model"))
        out = res[name] = {}
        x, w, cot = t(inp["x"]), t(inp["w"]), t(inp["cot"])
        with mesh:
            # the global (spmd) forms, and the local blocks' gradients
            out["row_global"] = ops.foopar_matmul_row(x, w, mesh=mesh)
            out["col_global"] = ops.foopar_matmul_col(x, w, mesh=mesh)
            xr, wr = local_block(x, P(None, None, "model"), mesh), local_block(w, P("model"), mesh)
            out["row"] = _grad_blocks(lambda a, b: (ops.foopar_matmul_row(a, b), cot), [xr, wr])
            wc, cc = local_block(w, P(None, "model"), mesh), local_block(cot, P(None, None, "model"),
                                                                         mesh)
            out["col"] = _grad_blocks(lambda a, b: (ops.foopar_matmul_col(a, b), cc), [x, wc])
            if shape == (2, 2):
                out["dns_global"] = ops.dns_matmul_2d(x, w, mesh=mesh)
                xd = local_block(x, P(None, None, "data"), mesh)
                wd = local_block(w, P("data", "model"), mesh)
                out["dns"] = _grad_blocks(lambda a, b: (ops.dns_matmul_2d(a, b), cc), [xd, wd])
            out["coll"] = _collectives(mesh, t(inp["coll"]) * (1 + mesh.rank))
        # the TP MLP and attention on the rank's batch rows and weight blocks
        for fsdp in (False, True):
            cfg = ModelConfig(**MLP_CFG)
            ctx = make_ctx(mesh, ParallelConfig(fsdp_params=fsdp, use_foopar_tp=True))
            specs = param_specs({"mlp": {k: t(v) for k, v in inp["mlp"].items()}}, cfg, ctx)
            p = {k: local_block(t(v), specs["mlp"][k], mesh) for k, v in inp["mlp"].items()}
            rows = lambda a: local_block(a, P("data"), mesh)
            names = sorted(p)
            with mesh:
                out[f"mlp_fsdp{fsdp}"] = _grad_blocks(
                    lambda hx, *ws: (L.mlp(dict(zip(names, ws)), hx, cfg, ctx),
                                     rows(t(inp["hcot"]))),
                    [rows(t(inp["hx"]))] + [p[k] for k in names])
        for cname, ckw in ATTN_CFGS.items():
            cfg = ModelConfig(**ckw)
            for lname, lkw in ATTN_LAYOUTS.items():
                ctx = make_ctx(mesh, ParallelConfig(**lkw))
                full = {k: t(v) for k, v in inp["attn"].items() if not isinstance(v, dict)}
                specs = param_specs({"attn": full}, cfg, ctx)["attn"]
                p = {k: local_block(v, specs[k], mesh) for k, v in full.items()}
                names = sorted(p)
                norms = {k: {"scale": t(v["scale"])} for k, v in inp["attn"].items()
                         if isinstance(v, dict)}
                rows = lambda a: local_block(a, P(ctx.batch_axes), mesh)
                positions = torch.arange(8)
                with mesh:
                    out[f"attn_{cname}_{lname}"] = _grad_blocks(
                        lambda hx, *ws: (L.attention(dict(zip(names, ws), **norms), hx,
                                                     positions, cfg, ctx=ctx)[0],
                                         rows(t(inp["hcot"]))),
                        [rows(t(inp["hx"]))] + [p[k] for k in names])
    return res


@pytest.fixture(scope="module")
def inp():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inp):
    return launch(4, _ranks, inp, device="cpu", timeout=300)


def _coords(r, shape):
    return dict(zip(("data", "model"), np.unravel_index(r, shape)))


def _block(a, spec, shape, r):
    """Rank r's block of numpy ``a`` under ``spec`` on the mesh ``shape``."""
    at = _coords(r, shape)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = {"data": shape[0], "model": shape[1]}[axis]
        blk = a.shape[d] // n
        a = np.take(a, range(at[axis] * blk, (at[axis] + 1) * blk), axis=d)
    return a


def _jax_grads(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@functools.lru_cache(maxsize=None)
def _jax_attention(cname):
    """JAX's single-device attention and its gradients (a function of the
    config only: every layout and mesh is held to it)."""
    inp = _inputs()
    jcfg = JModelConfig(**ATTN_CFGS[cname])
    mats = sorted(k for k, v in inp["attn"].items() if not isinstance(v, dict))
    norms = {k: {"scale": jnp.asarray(v["scale"])} for k, v in inp["attn"].items()
             if isinstance(v, dict)}
    pos = jnp.arange(8)
    fn = jax.jit(lambda hx, *ws: JL.attention(dict(zip(mats, ws), **norms), hx, pos, jcfg)[0])
    return mats, _jax_grads(fn, [inp["hx"]] + [inp["attn"][k] for k in mats], inp["hcot"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_backward_is_the_transpose(ranks, inp, mesh):
    shape = MESHES[mesh]
    blocks = [inp["coll"] * (1 + r) for r in range(4)]
    for r in range(4):
        out = ranks[r][mesh]["coll"]
        for k in ("all_to_all", "all_gather", "copy", "reduce_sum", "reduce_scatter", "split",
                  "gather_whole"):
            assert float(out[k]) == 0.0, (k, r)
        group = [q for q in range(4) if _coords(q, shape)["data"] == _coords(r, shape)["data"]]
        m, p = _coords(r, shape)["model"], len(group)
        want = np.concatenate([np.split(blocks[q], p, axis=1)[m] for q in group], axis=2)
        np.testing.assert_array_equal(out["all_to_all_fwd"], want)
        np.testing.assert_array_equal(out["all_gather_fwd"],
                                      np.concatenate([blocks[q] for q in group], axis=2))
        np.testing.assert_allclose(out["reduce_scatter_fwd"], np.split(
            sum(blocks[q] for q in group), p, axis=2)[m], rtol=1e-6)
        np.testing.assert_array_equal(out["split_fwd"], np.split(blocks[r], p, axis=2)[m])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_foopar_matmul_row_and_col_match_jax(ranks, inp, mesh):
    shape = MESHES[mesh]
    x, w, cot = inp["x"], inp["w"], inp["cot"]
    want, (dx, dw) = _jax_grads(lambda a, b: jnp.matmul(a, b), [x, w], cot)
    for r in range(4):
        out = ranks[r][mesh]
        np.testing.assert_allclose(out["row_global"], want, **TOL)
        np.testing.assert_allclose(out["col_global"], want, **TOL)
        y, (gx, gw) = out["row"]
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(gx, _block(dx, (None, None, "model"), shape, r), **TOL)
        np.testing.assert_allclose(gw, _block(dw, ("model", None), shape, r), **TOL)
        y, (gx, gw) = out["col"]
        np.testing.assert_allclose(y, _block(want, (None, None, "model"), shape, r), **TOL)
        np.testing.assert_allclose(gx, dx, **TOL)          # summed over the group
        np.testing.assert_allclose(gw, _block(dw, (None, "model"), shape, r), **TOL)


def test_dns_matmul_2d_matches_jax(ranks, inp):
    shape = MESHES["2x2"]
    x, w, cot = inp["x"], inp["w"], inp["cot"]
    want, (dx, dw) = _jax_grads(lambda a, b: jnp.matmul(a, b), [x, w], cot)
    for r in range(4):
        out = ranks[r]["2x2"]
        np.testing.assert_allclose(out["dns_global"], want, **TOL)
        y, (gx, gw) = out["dns"]
        np.testing.assert_allclose(y, _block(want, (None, None, "model"), shape, r), **TOL)
        np.testing.assert_allclose(gx, _block(dx, (None, None, "data"), shape, r), **TOL)
        np.testing.assert_allclose(gw, _block(dw, ("data", "model"), shape, r), **TOL)


def test_choose_tp_strategy_equals_jax():
    """The reference's ICI link passed to the port: the same decision over
    a grid of sizes (and the H100's NVLink gives a decision too)."""
    link = costmodel.LinkClass(rm.ICI.t_s, rm.ICI.t_w)
    seen = set()
    for m in (1, 7, 128, 4096, 65536):
        for n in (8, 1024, 8192):
            for p in (1, 2, 4, 16, 256):
                for b in (2, 4):
                    got = ops.choose_tp_strategy(m, 64, n, p, b, link=link)
                    assert got == jops.choose_tp_strategy(m, 64, n, p, b)
                    seen.add(got)
                    assert ops.choose_tp_strategy(m, 64, n, p, b) in ("row", "col")
    assert seen == {"row", "col"}


def _summed_over_data(ranks, key, shape, r, i):
    """Gradient ``i`` of ``key`` summed over the data group of rank r (the
    data-parallel reduction the train step makes)."""
    m = _coords(r, shape)["model"]
    return sum(ranks[q][key][1][i] for q in range(4) if _coords(q, shape)["model"] == m)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mlp_foopar_matches_jax(ranks, inp, mesh, fsdp):
    """``_mlp_foopar`` (column mapD, row zipWithD . reduceD) against JAX's
    single-device ``L.mlp`` and its gradients: batch rows over ``data``,
    weights over ``model`` (and ``data`` with FSDP, gathered)."""
    shape = MESHES[mesh]
    jcfg = JModelConfig(**MLP_CFG)
    names = sorted(inp["mlp"])
    want, grads = _jax_grads(lambda hx, *ws: JL.mlp(dict(zip(names, ws)), hx, jcfg),
                             [inp["hx"]] + [inp["mlp"][k] for k in names], inp["hcot"])
    spec = {"w_gate": ("data" if fsdp else None, "model"),
            "w_up": ("data" if fsdp else None, "model"),
            "w_down": ("model", "data" if fsdp else None)}
    key = f"mlp_fsdp{fsdp}"
    for r in range(4):
        y, g = ranks[r][mesh][key]
        np.testing.assert_allclose(y, _block(want, ("data",), shape, r), **TOL)
        np.testing.assert_allclose(g[0], _block(grads[0], ("data",), shape, r), **TOL)
        for i, k in enumerate(names, start=1):
            gk = g[i] if fsdp else _summed_over_data({q: ranks[q][mesh] for q in range(4)},
                                                     key, shape, r, i)
            np.testing.assert_allclose(gk, _block(grads[i], spec[k], shape, r), **TOL)


@pytest.mark.parametrize("layout", list(ATTN_LAYOUTS))
@pytest.mark.parametrize("cname", list(ATTN_CFGS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_attention_under_ctx_matches_jax(ranks, inp, mesh, cname, layout):
    """Attention on a mesh (q all-to-all to sequence-sharded full heads, k/v
    all-gathered, ``_sdpa_manual`` with the shard's row offset, the output
    all-to-all back for the row-parallel wo) against JAX's single-device
    ``L.attention``: outputs and every gradient."""
    shape = MESHES[mesh]
    mats, (want, grads) = _jax_attention(cname)
    lkw = ATTN_LAYOUTS[layout]
    dpom, fsdp = lkw.get("dp_over_model", False), lkw["fsdp_params"]
    model = None if dpom else "model"
    key = f"attn_{cname}_{layout}"

    def rows(a, r):
        if dpom:                                    # batch over both axes
            return np.split(a, 4, axis=0)[r]
        return _block(a, ("data",), shape, r)

    for r in range(4):
        y, g = ranks[r][mesh][key]
        np.testing.assert_allclose(y, rows(want, r), **TOL)
        np.testing.assert_allclose(g[0], rows(grads[0], r), **TOL)
        for i, k in enumerate(mats, start=1):
            spec = (model, "data" if fsdp else None) if k == "wo" else \
                ("data" if fsdp else None, model)
            if fsdp:                                # reduce-scattered by the gather
                got = g[i]
            else:
                got = sum(ranks[q][mesh][key][1][i] for q in range(4)
                          if dpom or _coords(q, shape)["model"] == _coords(r, shape)["model"])
            np.testing.assert_allclose(got, _block(grads[i], spec, shape, r), **TOL)
