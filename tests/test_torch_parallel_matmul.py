"""The port's distributed matmuls against the JAX package's, on the same inputs.

DNS (Algorithm 2) on 2x2x2, the generic Algorithm 1 on 8, SUMMA and Cannon
on 2x2 and 2x4, pipelined SUMMA on 1x8, 2x4 and 2x2 and 2.5D Cannon on
2x2x2, with the default local product and with the kernel entry points
(``*_kernel``, whose wrappers take the plain version for CPU tensors; on the
JAX side the ``*_pallas`` variants in interpret mode), plus the rectangular
(8 x 32) . (32 x 16) case.  The JAX side runs on 8 fake CPU devices (this file
as a script, in a subprocess); the port side on 8 and 4 gloo ranks.  The
bound is ``tests/progs/summa_prog.py``'s: rtol = atol = 1e-4.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = dict(rtol=1e-4, atol=1e-4)
MESHES = {"2x2x2": ((2, 2, 2), ("x", "y", "z")), "z8": ((8,), ("z",)),
          "2x2": ((2, 2), ("x", "y")), "2x4": ((2, 4), ("x", "y")),
          "1x8": ((1, 8), ("x", "y"))}
# (key, algorithm in the port, its JAX counterpart, mesh, operands)
CASES = [
    ("dns_2x2x2", "dns_matmul", "dns_matmul", "2x2x2", "sq"),
    ("dns_kernel_2x2x2", "dns_matmul_kernel", "dns_matmul_pallas", "2x2x2", "sq"),
    ("generic_z8", "generic_matmul", "generic_matmul", "z8", "sq"),
    ("cannon_25d_2x2x2", "cannon_matmul_25d", "cannon_matmul_25d", "2x2x2", "sq"),
    ("cannon_25d_kernel_2x2x2", "cannon_matmul_25d_kernel", "cannon_matmul_25d_pallas",
     "2x2x2", "sq"),
]
for _g in ("2x2", "2x4"):
    CASES += [
        (f"summa_{_g}", "summa_matmul", "summa_matmul", _g, "sq"),
        (f"summa_kernel_{_g}", "summa_matmul_kernel", "summa_matmul_pallas", _g, "sq"),
        (f"cannon_{_g}", "cannon_matmul", "cannon_matmul", _g, "sq"),
        (f"cannon_kernel_{_g}", "cannon_matmul_kernel", "cannon_matmul_pallas", _g, "sq"),
        (f"summa_rect_{_g}", "summa_matmul", "summa_matmul", _g, "rect"),
        (f"cannon_rect_{_g}", "cannon_matmul", "cannon_matmul", _g, "rect"),
    ]
for _g in ("1x8", "2x4", "2x2"):
    CASES += [
        (f"pipelined_{_g}", "summa_matmul_pipelined", "summa_matmul_pipelined", _g, "sq"),
        (f"pipelined_kernel_{_g}", "summa_matmul_pipelined_kernel",
         "summa_matmul_pipelined_pallas", _g, "sq"),
        (f"pipelined_rect_{_g}", "summa_matmul_pipelined", "summa_matmul_pipelined", _g, "rect"),
    ]
KEYS = [c[0] for c in CASES]


def _inputs():
    rng = np.random.RandomState(0)
    return {"sq": (rng.randn(32, 32).astype(np.float32), rng.randn(32, 32).astype(np.float32)),
            "rect": (rng.randn(8, 32).astype(np.float32), rng.randn(32, 16).astype(np.float32))}


def _call(mod, name, a, b, mesh):
    fn = getattr(mod, name)
    return fn(a, b, mesh, axis="z") if name == "generic_matmul" else fn(a, b, mesh)


def _port_side(device, inputs, world):
    from repro_torch import core
    meshes, out = {}, {}
    for key, name, _, grid, ops in CASES:
        shape, axes = MESHES[grid]
        if int(np.prod(shape)) != world:
            continue
        mesh = meshes.get(grid) or meshes.setdefault(grid, core.ProcessMesh(shape, axes))
        a, b = (torch.from_numpy(x).to(device) for x in inputs[ops])
        out[key] = _call(core, name, a, b, mesh)
    return out


def _jax_side(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax
    import jax.numpy as jnp
    from repro import core
    inputs = _inputs()
    meshes = {g: jax.make_mesh(s, a, devices=jax.devices()[:int(np.prod(s))])
              for g, (s, a) in MESHES.items()}
    out = {}
    for key, _, name, grid, ops in CASES:
        a, b = (jnp.asarray(x) for x in inputs[ops])
        fn = jax.jit(lambda a, b, name=name, mesh=meshes[grid]: _call(core, name, a, b, mesh))
        out[key] = np.asarray(fn(a, b))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.core import launch
    path = tmp_path_factory.mktemp("pmm") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    try:
        inputs = _inputs()
        port8 = launch(8, _port_side, inputs, 8, device="cpu", timeout=300)
        port4 = launch(4, _port_side, inputs, 4, device="cpu", timeout=300)
    finally:
        log, _ = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, log
    return dict(np.load(path)), port8, port4


@pytest.mark.parametrize("key", KEYS)
def test_parallel_matmul_matches_jax(results, key):
    jax_out, port8, port4 = results
    got = (port8[0] if key in port8[0] else port4[0])[key]
    np.testing.assert_allclose(got, jax_out[key], **TOL)
    ops = "rect" if "rect" in key else "sq"
    a, b = _inputs()[ops]
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, **TOL)


def test_every_rank_assembles_the_same_product(results):
    """The product is the same on every rank; DNS's C is replicated over z
    and each rank reads its own replica."""
    _, port8, port4 = results
    for ranks in (port8, port4):
        for r in ranks[1:]:
            assert r.keys() == ranks[0].keys()
            for k, v in r.items():
                np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)
    assert set(port8[0]) | set(port4[0]) == set(KEYS)


if __name__ == "__main__":
    _jax_side(sys.argv[1])
