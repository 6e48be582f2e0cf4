"""Port's paged decode attention against the JAX package's.

The plain PyTorch version (``repro_torch.kernels.paged_attention_ref``) is
held against the JAX reference ``ref.paged_attention`` and against the
Pallas kernel run in interpret mode, on the same numpy inputs.  The CUDA
kernel itself runs only on the card (``chip_smoke.py`` compares it with the
plain version there); here the wrapper must take the plain version because
the tensors lie on the CPU.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import paged_attention as pa

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _case(seed, b, hkv, rep, hd, n_blocks, blk, pages, dead_row=None,
          hole=None):
    """Random arena + per-request chains with garbage in unused blocks and
    past each row's length, -1 tail entries, partial last pages.
    ``dead_row``: a row whose table is all -1; ``hole``: (row, page) set to
    -1 below the row's length (a dead entry the kernel skips)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv, rep, hd).astype(np.float32)
    k = rng.randn(n_blocks, blk, hkv, hd).astype(np.float32)
    v = rng.randn(n_blocks, blk, hkv, hd).astype(np.float32)
    perm = rng.permutation(n_blocks)
    tables = np.full((b, pages), -1, np.int32)
    lengths = np.zeros((b,), np.int32)
    used = 0
    for row in range(b):
        lengths[row] = pages * blk if row == 0 else rng.randint(1, pages * blk)
        if row == dead_row:
            continue
        chain = -(-int(lengths[row]) // blk)
        tables[row, :chain] = perm[used:used + chain]
        used += chain
    if hole is not None:
        tables[hole] = -1
    return q, k, v, tables, lengths


def _jax(case, dtype=jnp.float32):
    q, k, v, t, ln = case
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            jnp.asarray(t), jnp.asarray(ln))


def _torch(case, dtype=torch.float32):
    q, k, v, t, ln = case
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(t), torch.from_numpy(ln))


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_matches_jax_ref(rep):
    """f32: every page below the length is live, where the plain version and
    the JAX reference share their semantics."""
    case = _case(0, b=3, hkv=2, rep=rep, hd=16, n_blocks=12, blk=4, pages=3)
    got = pa.paged_attention_ref(*_torch(case))
    want = ref.paged_attention(*_jax(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_matches_pallas_interpret(rep):
    """f32 against the TPU kernel in interpret mode, with a dead row and a
    dead entry below a row's length: both are skipped, the dead row is 0."""
    case = _case(1, b=3, hkv=2, rep=rep, hd=16, n_blocks=14, blk=4, pages=4,
                 dead_row=1, hole=(2, 0))
    got = pa.paged_attention_ref(*_torch(case))
    want = paged_attention_pallas(*_jax(case), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(got[1]) == 0


def test_plain_matches_jax_ref_bf16():
    """bf16: both round q * scale and the probabilities to bf16 the same
    way; they may differ by a flipped rounding of one probability and by
    the bf16 rounding of the output, about two bf16 ulps (2**-7) of the
    result -- hence atol = rtol = 2e-2."""
    case = _case(2, b=3, hkv=2, rep=4, hd=32, n_blocks=12, blk=4, pages=3)
    got = pa.paged_attention_ref(*_torch(case, torch.bfloat16))
    want = ref.paged_attention(*_jax(case, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_cpu_wrapper_runs_the_plain_version():
    case = _torch(_case(3, b=2, hkv=2, rep=2, hd=8, n_blocks=8, blk=4, pages=3,
                        dead_row=1))
    before = pa.launches
    got = pa.paged_attention(*case)
    assert pa.launches == before           # no kernel launch on the CPU
    torch.testing.assert_close(got, pa.paged_attention_ref(*case), atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, t, ln = _torch(_case(4, b=2, hkv=2, rep=2, hd=8, n_blocks=8, blk=4,
                                  pages=3))
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, t.long(), ln)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pa.paged_attention(q.double(), k, v, t, ln)
    with pytest.raises(ValueError, match="Hkv"):
        pa.paged_attention(q[:, :1].contiguous(), k, v, t, ln)
    with pytest.raises(ValueError, match="lengths"):
        pa.paged_attention(q, k, v, t, ln[:1])


def test_module_imports_without_nvcc_or_triton():
    """Importing the kernel modules builds nothing and needs neither nvcc
    nor triton: both come in only at the first launch on the card."""
    code = ("import sys; import repro_torch.kernels.paged_attention as pa; "
            "import repro_torch.models.transformer; "
            "from repro_torch.kernels import _build; "
            "print('triton' in sys.modules, len(_build._loaded))")
    env = dict(os.environ, PYTHONPATH=SRC, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "0"]
