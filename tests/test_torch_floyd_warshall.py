"""The port's Floyd-Warshall (paper Algorithm 3 and the blocked variant)
against the JAX package's, on 2x2 ranks.

Weights are integers with +inf for absent edges (vertex 0 has no outgoing
edge, so its row stays +inf off the diagonal); every path sum is an exact
f32 integer, so every variant must agree with the others exactly.  The JAX
side runs on 4 fake CPU devices (this file as a script, in a subprocess),
with its Pallas ``minplus`` in interpret mode for the blocked variant; the
port side on 4 gloo ranks, where ``ops.minplus`` takes its plain version
for CPU tensors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SIZES = (24, 32)
VARIANTS = ("floyd_warshall", "blocked", "blocked_minplus", "reference")


def _weights(n):
    rng = np.random.RandomState(n)
    w = rng.randint(1, 20, (n, n)).astype(np.float32)
    w[rng.rand(n, n) >= 0.12] = np.inf
    w[0] = np.inf
    np.fill_diagonal(w, 0)
    return w


def _port_side(device):
    from repro_torch import core
    from repro_torch.kernels import ops
    mesh = core.ProcessMesh((2, 2), ("x", "y"))
    out = {}
    for n in SIZES:
        d = torch.from_numpy(_weights(n)).to(device)
        out[f"floyd_warshall_{n}"] = core.floyd_warshall(d, mesh)
        out[f"blocked_{n}"] = core.blocked_floyd_warshall(d, mesh)
        out[f"blocked_minplus_{n}"] = core.blocked_floyd_warshall(d, mesh, minplus=ops.minplus)
        out[f"reference_{n}"] = core.floyd_warshall_reference(d)
        out[f"input_unchanged_{n}"] = torch.tensor(bool(torch.equal(d, torch.from_numpy(
            _weights(n)).to(device))))
    return out


def _jax_side(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from functools import partial

    import jax
    import jax.numpy as jnp
    from repro.core import blocked_floyd_warshall, floyd_warshall, floyd_warshall_reference
    from repro.kernels import ops
    mesh = jax.make_mesh((2, 2), ("x", "y"))
    out = {}
    for n in SIZES:
        d = jnp.asarray(_weights(n))
        out[f"floyd_warshall_{n}"] = floyd_warshall(d, mesh)
        out[f"blocked_{n}"] = blocked_floyd_warshall(d, mesh)
        out[f"blocked_minplus_{n}"] = blocked_floyd_warshall(
            d, mesh, minplus=partial(ops.minplus, uk=4, interpret=True))
        out[f"reference_{n}"] = floyd_warshall_reference(d)
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.core import launch
    path = tmp_path_factory.mktemp("fw") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    try:
        port = launch(4, _port_side, device="cpu", timeout=300)
    finally:
        log, _ = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, log
    return dict(np.load(path)), port


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_floyd_warshall_matches_jax_exactly(results, variant, n):
    jax_out, port = results
    key = f"{variant}_{n}"
    np.testing.assert_array_equal(port[0][key], jax_out[key])
    np.testing.assert_array_equal(port[0][key], jax_out[f"reference_{n}"])
    for r in port[1:]:
        np.testing.assert_array_equal(r[key], port[0][key])


@pytest.mark.parametrize("n", SIZES)
def test_inputs_and_unreachable_vertex(results, n):
    """No variant writes into its input, and vertex 0 (no outgoing edge)
    reaches nothing but itself."""
    _, port = results
    assert all(bool(r[f"input_unchanged_{n}"]) for r in port)
    row0 = port[0][f"reference_{n}"][0]
    assert row0[0] == 0 and np.isinf(row0[1:]).all()
    assert np.isfinite(port[0][f"reference_{n}"][1:, 0]).any()


if __name__ == "__main__":
    _jax_side(sys.argv[1])
