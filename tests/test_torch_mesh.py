"""The port's SPMD runtime (``repro_torch.core.mesh``): the process mesh,
``permute`` with JAX ``ppermute`` semantics, host staging, spec slicing and
assembly, and ``launch``'s handling of ranks that fail or hang."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import P, ProcessMesh, launch, spmd
from repro_torch.core.mesh import current, local_block


def _semantics(device):
    mesh = ProcessMesh((2, 2), ("x", "y"))
    r = mesh.rank
    out = {"coords": torch.tensor(mesh.coords), "lin_xy": torch.tensor(mesh.index(("x", "y")))}
    x = torch.full((3,), float(r + 1), device=device)
    with mesh:
        # 0 -> 1, 1 -> 1 is illegal; use 0 -> 1, 2 -> 2 (self), 3 receives nothing
        out["permute"] = mesh.permute(x, [(0, 1), (1, 0), (2, 2)], ("x", "y"))
        out["permute_async"] = mesh.permute(x, [(0, 1), (1, 0), (2, 2)], ("x", "y"),
                                            async_op=True).wait()
        before = mesh.staged_bytes
        mesh.all_reduce(x, "sum", "y")
        out["staged_all_reduce"] = torch.tensor(mesh.staged_bytes - before)
        try:
            mesh.permute(x, [(0, 1), (0, 2)], ("x", "y"))
            out["double_send_raises"] = torch.tensor(False)
        except ValueError:
            out["double_send_raises"] = torch.tensor(True)
        try:
            mesh.size(("y", "x"))
            out["axis_order_raises"] = torch.tensor(False)
        except ValueError:
            out["axis_order_raises"] = torch.tensor(True)
    g = torch.arange(4 * 6, dtype=torch.float32, device=device).reshape(4, 6)
    blk = local_block(g, P("x", "y"), mesh)
    out["block_is_view"] = torch.tensor(blk.data_ptr() == g[blk.shape[0] * mesh.coords[0]:,
                                                            blk.shape[1] * mesh.coords[1]:]
                                        .data_ptr())
    out["roundtrip"] = spmd(lambda b: b * 1, mesh, P("x", "y"), P("x", "y"))(g)
    out["replicated"] = spmd(lambda b: b.sum()[None], mesh, P("x", "y"), P(None))(g)
    out["rows_only"] = spmd(lambda b: b, mesh, P("x", None), P("x", None))(g)
    return out


def _fails(device):
    if torch.distributed.get_rank() == 1:
        raise ZeroDivisionError("rank one gives up")
    time.sleep(60)


def _hangs(device):
    time.sleep(60)


@pytest.fixture(scope="module")
def sem():
    return launch(4, _semantics, device="cpu", timeout=120)


def test_mesh_is_row_major(sem):
    for r, out in enumerate(sem):
        assert tuple(out["coords"].tolist()) == divmod(r, 2)
        assert int(out["lin_xy"]) == r


def test_permute_zeros_self_pairs_and_async(sem):
    want = {0: 2.0, 1: 1.0, 2: 3.0, 3: 0.0}       # 3 receives nothing: zeros
    for r, out in enumerate(sem):
        np.testing.assert_array_equal(out["permute"], np.full(3, want[r], np.float32))
        np.testing.assert_array_equal(out["permute_async"], out["permute"])
        assert bool(out["double_send_raises"]) and bool(out["axis_order_raises"])


def test_host_staging_is_counted(sem):
    """An all_reduce of 12 bytes stages 12 bytes out and 12 back."""
    assert all(int(out["staged_all_reduce"]) == 24 for out in sem)


def test_spec_slicing_and_assembly(sem):
    g = np.arange(24, dtype=np.float32).reshape(4, 6)
    for r, out in enumerate(sem):
        assert bool(out["block_is_view"])
        np.testing.assert_array_equal(out["roundtrip"], g)
        np.testing.assert_array_equal(out["rows_only"], g)
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(out["replicated"], [g[2 * i:2 * i + 2, 3 * j:3 * j + 3].sum()])


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one gives up"):
        launch(2, _fails, device="cpu", timeout=120)


def test_a_hanging_rank_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch(2, _hangs, device="cpu", timeout=8)
    assert time.monotonic() - t0 < 40


def test_no_silent_cpu_fallback_and_no_mesh_outside_spmd():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            launch(2, _hangs)
    with pytest.raises(RuntimeError, match="no active ProcessMesh"):
        current()
