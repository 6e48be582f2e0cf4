"""The dry run's cells against the JAX package's (``launch/specs.py``), the
counterpart of ``tests/test_system.py::test_build_cell_all_40``.

On the production mesh (16, 16) as an ``AbstractMesh`` (no process behind
it) every (arch x shape) cell is counted, the 7 skipped ones (full
attention at 500k tokens) are skipped, and each other cell's abstract
inputs -- ``meta`` tensors -- have the shapes and dtypes of JAX's
``ShapeDtypeStruct``s, their specs JAX's shardings' specs, and the cache
specs JAX's modulo the stacked periods dim.  ``init_abstract`` allocates
nothing: every leaf is on ``meta``, with the reference's parameter count.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import SHAPES as JSHAPES
from repro.config import ParallelConfig as JParallelConfig
from repro.core.compat import abstract_mesh
from repro.launch import specs as jspecs
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.config import SHAPES, ParallelConfig
from repro_torch.core.mesh import AbstractMesh
from repro_torch.launch.specs import abstract_cache, build_cell
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, leaves_with_path

MESH, AXES = (16, 16), ("data", "model")


def _norm(spec) -> tuple:
    """A spec as a tuple whose one-axis tuples are that axis (as ``P``)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


def _jax_cache_leaf(jtree, cfg, path):
    """JAX's leaf for the port cache leaf at ``path`` (layer i: period
    i // len(pattern), kind i % len(pattern))."""
    if cfg.enc_dec:
        return jtree["attn"][path[1]]
    entry = jtree[path[0] % len(cfg.block_pattern)]
    rest = path[1:]
    if isinstance(rest[0], int):                  # an attention kind's (K, V)
        return entry["attn"][rest[0]]
    for k in rest:
        entry = entry[k]
    return entry


def _cells():
    return [(a, s, skip) for a, s, skip in configs.cells()]


def test_cells_are_the_references():
    assert _cells() == jconfigs.cells()
    assert len(_cells()) == 40 and sum(skip for *_, skip in _cells()) == 7


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, skip in _cells() if not skip])
def test_build_cell_equals_jax(arch, shape):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    cell = build_cell(cfg, SHAPES[shape], AbstractMesh(MESH, AXES), ParallelConfig())
    jcell = jspecs.build_cell(jcfg, JSHAPES[shape], abstract_mesh(MESH, AXES),
                              JParallelConfig())
    assert cell.kind == jcell.kind == SHAPES[shape].kind
    assert cell.ctx.batch_axes == jcell.ctx.batch_axes
    assert len(cell.abstract_args) == len(jcell.abstract_args)
    for i, (arg, jarg, sh, jsh) in enumerate(zip(cell.abstract_args, jcell.abstract_args,
                                                  cell.in_shardings, jcell.in_shardings)):
        if cell.kind != "train" and i == 1:                     # the cache
            n = 0
            for (path, leaf), (_, spec) in zip(leaves_with_path(arg), leaves_with_path(sh)):
                jleaf = _jax_cache_leaf(jarg, cfg, path)
                jspec = _jax_cache_leaf(jsh, cfg, path).spec
                assert leaf.device.type == "meta"
                assert tuple(leaf.shape) == tuple(jleaf.shape[1:]), path
                assert _dtype(leaf) == str(jleaf.dtype), path
                assert jspec[0] is None and _norm(spec) == _norm(jspec[1:]), (path, spec, jspec)
                n += 1
            assert n == len(jax.tree.leaves(jarg)) * (cfg.n_layers if cfg.enc_dec
                                                      else cfg.n_periods)
            continue
        got, want = leaves_with_path(arg), jax.tree_util.tree_leaves_with_path(jarg)
        specs, jspecs_ = leaves(sh), jax.tree.leaves(jsh)
        assert len(got) == len(want) == len(specs) == len(jspecs_)
        for (_, leaf), (_, jleaf), spec, jspec in zip(got, want, specs, jspecs_):
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(jleaf.shape) and _dtype(leaf) == str(jleaf.dtype)
            assert _norm(spec) == _norm(jspec.spec)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_init_abstract_allocates_nothing(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    if cfg.enc_dec:
        tree = E.init_abstract(cfg)
        want = jax.eval_shape(lambda: JE.init(jax.random.PRNGKey(0), jcfg))
    else:
        tree = T.init_abstract(cfg)
        want = JT.init_abstract(jcfg)
    assert all(t.device.type == "meta" for t in leaves(tree))
    assert sum(t.numel() for t in leaves(tree)) == sum(
        int(np.prod(t.shape)) for t in jax.tree.leaves(want))
    assert {_dtype(t) for t in leaves(tree)} == {str(t.dtype) for t in jax.tree.leaves(want)}
    cache = abstract_cache(cfg, 2, 64)
    assert all(t.device.type == "meta" for t in leaves(cache))
    assert all(t.dtype in (torch.bfloat16, torch.float32) for t in leaves(cache))
