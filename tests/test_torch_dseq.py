"""The port's Table-1 algebra and grid helpers against the JAX package's.

Each program below is one SPMD body written once against the DSeq / Grid2D
API, which the two packages share.  The JAX side runs it under ``shard_map``
on 8 fake CPU devices (this file run as a script, in a subprocess, so that
``XLA_FLAGS`` is set before JAX is imported); the port side runs it on 8 (and
6) gloo ranks through ``repro_torch.core.mesh.launch(device="cpu")``.  Both
take the same seeded numpy inputs.  Every output must agree with JAX's, and
every rank's assembled output must be the same (replicated values agree).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(8, 4).astype(np.float32),
        "z": np.arange(64, dtype=np.float32).reshape(8, 8),
        "w": rng.randn(8, 8, 5).astype(np.float32),
        "x6": rng.randn(6, 3).astype(np.float32),
        "g": rng.randn(4, 12).astype(np.float32),
        "q": np.arange(8, dtype=np.int32),
    }


# -- the SPMD bodies, shared by both sides (``L`` is the side's namespace) --
def _seq_body(L, xl):
    s = L.DSeq(xl[0], "x")
    add = lambda a, b: a + b  # noqa: E731
    return (s.reduceD("sum"), s.reduceD(add), s.reduceD(L.minimum), s.reduceD("min"),
            s.reduceD("max"), s.reduceD(add, root=3)[None], s.reduceD("sum", root=3)[None],
            s.shiftD(3).local[None], s.shiftD(-2).local[None], s.allGatherD(),
            L.DSeq(xl, "x").allGatherD(tiled=True), s.apply(5), s.scanD().local[None],
            s.scanD(inclusive=True).local[None], s.scanD(L.maximum, inclusive=True).local[None],
            s.ringShiftD().local[None], s.ringShiftD(reverse=True).local[None],
            s.allGatherRingD(), s.mapIdxD(lambda i, v: v * (i + 1)).local[None])


SEQ_OUTS = [("reduce_sum", (None,)), ("reduce_tree", (None,)), ("reduce_min_tree", (None,)),
            ("reduce_min", (None,)), ("reduce_max", (None,)),
            ("reduce_tree_root3", ("x", None)), ("reduce_sum_root3", ("x", None)),
            ("shift3", ("x", None)), ("shift_neg2", ("x", None)), ("all_gather", (None, None)),
            ("all_gather_tiled", (None, None)), ("apply5", (None,)),
            ("scan_exclusive", ("x", None)), ("scan_inclusive", ("x", None)),
            ("scan_max", ("x", None)), ("ring_shift", ("x", None)),
            ("ring_shift_reverse", ("x", None)), ("all_gather_ring", (None, None)),
            ("map_idx", ("x", None))]


def _a2a_body(L, zl):
    return (L.DSeq(zl.reshape(8, 1), "x").allToAllD().local.reshape(1, 8),)


def _rs_body(L, wl):
    return (L.DSeq(wl[0], "x").reduceScatterD().local[None],
            L.reduce_scatter_d(wl[0], lambda a, b: a + b, "x")[None])


def _six_body(L, xl):
    s = L.DSeq(xl[0], "x")
    add = lambda a, b: a + b  # noqa: E731
    return (s.reduceD(add), s.reduceD(add, root=4)[None],
            s.scanD(inclusive=True).local[None], s.allGatherRingD())


def _grid_body(L, lx):
    g = L.Grid2D()
    add = lambda a, b: a + b  # noqa: E731
    outs = [g.bcast_row(lx, s) for s in range(4)] + [g.bcast_col(lx, s) for s in range(2)]
    for s in range(4):
        st = g.bcast_row_ring_start(lx, s)
        for _ in range(3):
            st = g.bcast_row_ring_next(st)
        outs.append(st.value)
    for s in range(2):
        st = g.bcast_col_ring_next(g.bcast_col_ring_start(lx, s))
        outs.append(st.value)
    i, j = g.coords
    outs += [g.reduce_row(lx), g.reduce_col(lx), g.reduce_row(lx, add, root=1),
             g.reduce_col(lx, add), g.shift_row(lx, 1), g.shift_row(lx, -1),
             g.shift_col(lx, 1), g.skew(lx, by_row=True), g.skew(lx, by_row=False),
             g.skew(lx, by_row=True, scale=2), g.xSeq(lx).reduceD("sum"),
             g.ySeq(lx).apply(2), lx * 0 + g.mapD(lambda a, b: a * 10 + b) + i - j]
    return tuple(outs)


GRID_OUTS = ([(f"bcast_row_src{s}", ("x", "y")) for s in range(4)] +
             [(f"bcast_col_src{s}", ("x", "y")) for s in range(2)] +
             [(f"ring_bcast_row_src{s}", ("x", "y")) for s in range(4)] +
             [(f"ring_bcast_col_src{s}", ("x", "y")) for s in range(2)] +
             [(k, ("x", "y")) for k in ("reduce_row", "reduce_col", "reduce_row_tree_root1",
                                         "reduce_col_tree", "shift_row1", "shift_row_neg1",
                                         "shift_col1", "skew_a", "skew_b", "skew_a_scale2",
                                         "xseq_reduce", "yseq_apply2", "grid_map")])


def _quickstart_body(L, local):
    s = L.DSeq(local[0], "x")
    counts = s.mapD(lambda v: sum((v >> b) & 1 for b in range(4)))   # popcount
    return counts.local[None], counts.reduceD("sum"), counts.apply(3)


# (name, mesh shape, axes, input, in spec, body, outputs)
PROGRAMS = [
    ("seq", (8,), ("x",), "x", ("x", None), _seq_body, SEQ_OUTS),
    ("a2a", (8,), ("x",), "z", ("x", None), _a2a_body, [("all_to_all", ("x", None))]),
    ("rs", (8,), ("x",), "w", ("x", None, None), _rs_body,
     [("reduce_scatter_sum", ("x", None, None)), ("reduce_scatter_ring", ("x", None, None))]),
    ("grid", (2, 4), ("x", "y"), "g", ("x", "y"), _grid_body, GRID_OUTS),
    ("quickstart", (8,), ("x",), "q", ("x",), _quickstart_body,
     [("popcounts", ("x",)), ("popcount_total", ()), ("popcount_apply3", ())]),
    ("six", (6,), ("x",), "x6", ("x", None), _six_body,
     [("six_reduce_tree", (None,)), ("six_reduce_tree_root4", ("x", None)),
      ("six_scan_inclusive", ("x", None)), ("six_all_gather_ring", (None, None))]),
]
KEYS = [k for prog in PROGRAMS for k, _ in prog[6]]


# -- the port side: gloo ranks ----------------------------------------------
def _torch_ns():
    from repro_torch.core import DSeq, Grid2D
    from repro_torch.core.dseq import reduce_scatter_d
    return types.SimpleNamespace(DSeq=DSeq, Grid2D=Grid2D, reduce_scatter_d=reduce_scatter_d,
                                 minimum=torch.minimum, maximum=torch.maximum)


def _port_side(device, inputs, world):
    from repro_torch.core import P, ProcessMesh, spmd
    L = _torch_ns()
    meshes, out = {}, {}
    for name, shape, axes, inp, in_spec, body, outs in PROGRAMS:
        if int(np.prod(shape)) != world:
            continue
        mesh = meshes.get(shape) or meshes.setdefault(shape, ProcessMesh(shape, axes))
        fn = spmd(lambda xl, body=body: body(L, xl), mesh, P(*in_spec),
                  tuple(P(*s) for _, s in outs))
        res = fn(torch.from_numpy(inputs[inp]).to(device))
        out.update({k: v for (k, _), v in zip(outs, res)})
    return out


# -- the JAX side: this file run as a script ---------------------------------
def _jax_side(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro.core import DSeq, spmd
    from repro.core.dseq import reduce_scatter_d
    from repro.core.grid import Grid2D
    L = types.SimpleNamespace(DSeq=DSeq, Grid2D=Grid2D, reduce_scatter_d=reduce_scatter_d,
                              minimum=jnp.minimum, maximum=jnp.maximum)
    inputs = _inputs()
    out = {}
    for name, shape, axes, inp, in_spec, body, outs in PROGRAMS:
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n])
        fn = jax.jit(spmd(lambda xl, body=body: body(L, xl), mesh, JP(*in_spec),
                          tuple(JP(*s) for _, s in outs)))
        res = fn(jnp.asarray(inputs[inp]))
        out.update({k: np.asarray(v) for (k, _), v in zip(outs, res)})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.core import launch
    path = tmp_path_factory.mktemp("dseq") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    try:
        inputs = _inputs()
        port8 = launch(8, _port_side, inputs, 8, device="cpu", timeout=300)
        port6 = launch(6, _port_side, inputs, 6, device="cpu", timeout=300)
    finally:
        log, _ = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, log
    port = [{**a, **b} for a, b in zip(port8, port6 + [{}] * 2)]
    return dict(np.load(path)), port


@pytest.mark.parametrize("key", KEYS)
def test_dseq_op_matches_jax(results, key):
    jax_out, port = results
    np.testing.assert_allclose(port[0][key], jax_out[key], **TOL)


def test_replicas_agree(results):
    """Every rank assembles the same global values (replicated axes read at
    the rank's own coordinate must agree with coordinate 0)."""
    _, port = results
    assert len(port[0]) == len(KEYS)
    for r in range(1, 8):
        for k, v in port[r].items():
            np.testing.assert_array_equal(v, port[0][k], err_msg=f"{k} on rank {r}")


def test_quickstart_values(results):
    """The quickstart's FooPar example: popcounts of 0..7, their reduceD (+)
    and apply(3)."""
    _, port = results
    assert port[0]["popcounts"].tolist() == [0, 1, 1, 2, 1, 2, 2, 3]
    assert int(port[0]["popcount_total"]) == 12
    assert int(port[0]["popcount_apply3"]) == 2


if __name__ == "__main__":
    _jax_side(sys.argv[1])
