"""Port's paged decode attention against the JAX package's.

The plain PyTorch version (``repro_torch.kernels.paged_attention_ref``) is
held against the JAX reference ``ref.paged_attention`` and against the
Pallas kernel run in interpret mode, on the same numpy inputs.  The CUDA
kernel itself runs only on the card (``chip_smoke.py`` compares it with the
plain version there); here the wrapper must take the plain version because
the tensors lie on the CPU.
"""
import inspect
import json
import math
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_matches_pallas_interpret(dtype):
    """A non-default ``scale`` (0.05, not 1/sqrt(16) = 0.25) through the
    wrapper on the CPU, against the TPU kernel in interpret mode with the
    same scale, with a dead row and a dead entry; the default stays
    1/sqrt(hd)."""
    case = _case(8, b=3, hkv=2, rep=3, hd=16, n_blocks=14, blk=4, pages=4,
                 dead_row=1, hole=(2, 0))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got = pa.paged_attention(*_torch(case, dtype), scale=0.05)
    want = paged_attention_pallas(*_jax(case, jdt), scale=0.05, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    default = pa.paged_attention(*_torch(case, dtype))
    assert not torch.allclose(got.float(), default.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(default, pa.paged_attention(*_torch(case, dtype), scale=0.25),
                               atol=0, rtol=0)


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


# ---------------------------------------------------------------------------
# the kernel's split-KV arithmetic, modelled in PyTorch on the CPU

def _split_model(q, k_pages, v_pages, block_tables, lengths, pps, chunk=2):
    """What the CUDA kernel computes, in f32: the table is cut into splits
    of ``pps`` pages; each split folds its pages, in chunks of ``chunk``
    positions that never cross a page, into an online-softmax state
    (m, l, acc) with one rescale per chunk, as a lane group does, in the
    log2 domain (q scaled by scale * log2 e, exp2 throughout); the combine
    weighs each split by 2^(m_s - max m), sums, and divides by the summed l
    (0 where it is 0).  Dead (-1 or >= N) entries and positions at or past
    the length are masked, never read into the sums."""
    b, hkv, rep, hd = q.shape
    n_blocks, blk = k_pages.shape[:2]
    pages = block_tables.shape[1]
    n_splits = -(-pages // pps)
    idx = block_tables.long().clamp(0, n_blocks - 1)
    k = k_pages[idx].reshape(b, pages * blk, hkv, hd).float()
    v = v_pages[idx].reshape(b, pages * blk, hkv, hd).float()
    s = torch.einsum("bgrd,bkgd->bgrk", q.float() * (math.log2(math.e) / math.sqrt(hd)), k)
    live = ((block_tables >= 0) & (block_tables < n_blocks)).repeat_interleave(blk, dim=1)
    mask = (torch.arange(pages * blk)[None] < lengths.long()[:, None]) & live
    parts = []
    for sp in range(n_splits):
        m = torch.full((b, hkv, rep), pa.NEG_INF)
        l = torch.zeros((b, hkv, rep))
        acc = torch.zeros((b, hkv, rep, hd))
        for page in range(sp * pps, min((sp + 1) * pps, pages)):
            for lo in range(page * blk, (page + 1) * blk, chunk):
                hi = min(lo + chunk, (page + 1) * blk)
                ok = mask[:, None, None, lo:hi]
                sc = s[..., lo:hi].masked_fill(~ok, pa.NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.where(ok, torch.exp2(sc - m_new[..., None]), torch.zeros(()))
                l = alpha * l + p.sum(-1)
                acc = alpha[..., None] * acc + torch.einsum("bgrk,bkgd->bgrd", p, v[:, lo:hi])
                m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([p[0] for p in parts])
    w = torch.exp2(m_all - m_all.amax(0))
    l = (w * torch.stack([p[1] for p in parts])).sum(0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return torch.where(l[..., None] == 0, torch.zeros(()), acc / torch.where(
        l == 0, torch.ones(()), l)[..., None])


@pytest.mark.parametrize("pps", [6, 2, 1])                   # S = 1, 3, P
@pytest.mark.parametrize("chunk", [1, 3])
def test_split_model_matches_jax_ref(pps, chunk):
    """Every page below each length live: the split-and-combine arithmetic
    against ``ref.paged_attention`` in f32, with splits past a row's length
    (empty) and partial last pages."""
    case = _case(5, b=4, hkv=2, rep=3, hd=16, n_blocks=24, blk=4, pages=6)
    got = _split_model(*_torch(case), pps=pps, chunk=chunk)
    want = ref.paged_attention(*_jax(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pps", [6, 2, 1])                   # S = 1, 3, P
def test_split_model_matches_pallas_interpret(pps):
    """Against the TPU kernel in interpret mode, with an all-dead row
    (exactly 0), a dead entry below a row's length (with pps = 1 a split
    that is empty though below the length) and partial last pages."""
    case = _case(6, b=4, hkv=2, rep=2, hd=16, n_blocks=24, blk=4, pages=6,
                 dead_row=2, hole=(0, 1))
    got = _split_model(*_torch(case), pps=pps)
    want = paged_attention_pallas(*_jax(case), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(got[2]) == 0
    assert torch.isfinite(got).all()


def test_split_model_empty_splits_weigh_nothing():
    """A row live only in its first page: every later split is empty
    (m = -1e30, l = 0) and must not change the result or make a NaN; a row
    whose splits are all empty (length 0) writes exactly 0."""
    q, k, v, t, ln = _torch(_case(7, b=2, hkv=1, rep=1, hd=8, n_blocks=12, blk=4,
                                  pages=6))
    ln = torch.tensor([3, 0], dtype=torch.int32)
    one = _split_model(q, k, v, t, ln, pps=6)
    for pps in (2, 1):
        got = _split_model(q, k, v, t, ln, pps=pps)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, one, atol=1e-6, rtol=1e-6)
    assert torch.count_nonzero(one[1]) == 0
    np.testing.assert_allclose(one.numpy(), pa.paged_attention_ref(q, k, v, t, ln).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_split_plan_covers_every_page_once():
    """The host's split choice: S >= 1 splits of pps pages cover each table
    page exactly once with no split past the table; the serve shape (B 4,
    Hkv 8, P 36) puts a block on every one of 132 SMs; S = 1 once B * Hkv
    >= 2 * 132.  It takes shapes only, never the lengths."""
    assert list(inspect.signature(pa.split_plan).parameters) == ["batch", "hkv", "pages",
                                                                 "n_sm"]
    for batch in (1, 2, 4, 17, 33, 64, 200):
        for hkv in (1, 2, 8):
            for pages in (1, 2, 3, 7, 36, 512, 1000):
                for n_sm in (132, 114, 1):
                    n_splits, pps = pa.split_plan(batch, hkv, pages, n_sm)
                    assert n_splits >= 1 and pps >= 1
                    covered = [p for sp in range(n_splits)
                               for p in range(sp * pps, min((sp + 1) * pps, pages))]
                    assert covered == list(range(pages))
                    assert (n_splits - 1) * pps < pages
                    if batch * hkv >= 2 * n_sm:
                        assert n_splits == 1
    n_splits, pps = pa.split_plan(4, 8, 36, 132)
    assert n_splits * 4 * 8 >= 132 and (n_splits, pps) == (9, 4)
    assert pa.split_plan(1, 8, 512, 132)[0] * 8 >= 132
    assert pa.split_plan(64, 8, 36, 132) == (1, 36)


def test_serve_shape_block_leaves_room_for_four_on_an_sm():
    """The split block's shared memory at the serve shape (rep 3, hd 128,
    bf16 arenas, 4 pages a split) lets four blocks share an SM's 228 KB
    (1 KB of it reserved a block), so the 288 blocks run in one wave."""
    assert 4 * (pa._smem_bytes(3, 128, 2, 4) + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtypes,rep,hd,macros", [
    ((torch.bfloat16, torch.bfloat16), 16, 128, "0.0.16.16"),
    ((torch.float32, torch.bfloat16), 3, 256, "1.0.3.32"),
    ((torch.float32, torch.float32), 1, 64, "1.1.1.16"),
])
def test_a_launch_builds_only_its_own_instantiation(tmp_path, monkeypatch, dtypes, rep, hd,
                                                    macros):
    """The wrapper's library is the variant of its launch: ``nvcc`` gets the
    launch's dtype codes, group and lanes a token as macros, which the
    source reads, and the library is named by them; the whole source keeps
    its own library, built with no macro."""
    from repro_torch.kernels import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    "a = sys.argv[1:]\nopen(a[a.index('-o') + 1], 'w').write(json.dumps(a))\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    variant = pa._variant(*dtypes, rep, hd)
    report = _build.build([("paged_attention", variant), "paged_attention"])
    assert sorted(report) == sorted(["paged_attention", f"paged_attention.{macros}"])
    lib = _build.library_path(("paged_attention", variant))
    assert lib.name == f"libpaged_attention.{macros}.so"
    argv = json.loads(lib.read_text())
    defines = [a for a in argv if a.startswith("-D")]
    assert defines == [f"-D{k}={v}" for k, v in zip(
        ("REPRO_PA_Q", "REPRO_PA_KV", "REPRO_PA_REP", "REPRO_PA_G"), macros.split("."))]
    whole = json.loads(_build.library_path("paged_attention").read_text())
    assert not [a for a in whole if a.startswith("-D")]
    source = _build.sources()["paged_attention"].read_text()
    assert all(f"== {k}" in source for k, _ in variant)
    # built once: a second request finds the library
    assert _build.build([("paged_attention", variant)])[lib.stem[3:]]["seconds"] == 0.0
