"""The port's matmul, matmul_acc and minplus against the JAX package's.

The wrappers of ``repro_torch.kernels`` take their plain versions for CPU
tensors; these are held against the Pallas kernels in interpret mode and
against ``kernels/ref.py`` on the same numpy inputs, over the reference's
own shape sweeps and bounds (``tests/test_kernels.py``).  The CUDA kernels
run only on the card: ``chip_smoke.py`` holds them against these plain
versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import matmul as km
from repro_torch.kernels import minplus as kmp
from repro_torch.kernels import ops

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 256, 128, 128, 256),
    (512, 256, 384, 256, 128, 128),
    (64, 64, 64, 64, 64, 64),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_matmul_matches_pallas(m, k, n, bm, bn, bk, dtype):
    rng = np.random.RandomState(m + k + n)
    a, b = rng.randn(m, k).astype(dtype), rng.randn(k, n).astype(dtype)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    tol = 2e-2 if dtype == np.float16 else 1e-4
    for want in (jops.matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn, bk=bk,
                             interpret=True), ref.matmul(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol * 10)


def test_matmul_out_dtype():
    rng = np.random.RandomState(1)
    a, b = rng.randn(64, 32).astype(np.float16), rng.randn(32, 48).astype(np.float16)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), out_dtype=torch.float16)
    want = ref.matmul(jnp.asarray(a), jnp.asarray(b), out_dtype=jnp.float16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 256, 128, 128, 256),
    (64, 64, 64, 64, 64, 64),
])
def test_matmul_acc_matches_pallas(m, k, n, bm, bn, bk):
    """matmul_acc(a, b, c) == c + a @ b, written into c's storage."""
    rng = np.random.RandomState(m * 3 + k + n)
    a, b, c = (rng.randn(*s).astype(np.float32) for s in ((m, k), (k, n), (m, n)))
    want = jops.matmul_acc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), bm=bm, bn=bn,
                           bk=bk, interpret=True)
    ct = torch.from_numpy(c.copy())
    got = ops.matmul_acc(torch.from_numpy(a), torch.from_numpy(b), ct)
    assert got.data_ptr() == ct.data_ptr()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ct.numpy(), c + np.asarray(ref.matmul(a, b)), rtol=1e-4,
                               atol=1e-3)


def test_matmul_acc_on_a_column_panel():
    """The panel loops pass column slices of a block (unit inner stride, a
    row stride wider than the panel); c is updated in place."""
    rng = np.random.RandomState(3)
    blk = torch.from_numpy(rng.randn(32, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(16, 24).astype(np.float32))
    c = torch.zeros((32, 24))
    panel = blk[:, 16:32]
    assert panel.stride() == (64, 1)
    ops.matmul_acc(panel, b, c)
    np.testing.assert_allclose(c.numpy(), panel.numpy() @ b.numpy(), rtol=1e-5, atol=1e-5)


def _minplus_inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    a, b = (rng.rand(m, k) * 10).astype(np.float32), (rng.rand(k, n) * 10).astype(np.float32)
    a[rng.rand(m, k) < 0.1] = np.inf
    b[rng.rand(k, n) < 0.1] = np.inf
    return a, b


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 64, 128), (64, 256, 64)])
@pytest.mark.parametrize("uk", [4, 8])
def test_minplus_matches_pallas(m, k, n, uk):
    a, b = _minplus_inputs(m, k, n, m + k + n + uk)
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b))
    want = jops.minplus(jnp.asarray(a), jnp.asarray(b), bm=64, bn=64, bk=64, uk=uk,
                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.minplus(a, b)))


def test_minplus_chunks_agree_exactly(monkeypatch):
    """The plain version's running minimum over k chunks gives the one-shot
    minimum bit for bit, whatever the chunk."""
    a, b = _minplus_inputs(48, 37, 40, 5)
    want = np.asarray(ref.minplus(a, b))
    for elems in (1, 48 * 40 * 3, 1 << 26):
        monkeypatch.setattr(kmp, "_REF_CHUNK_ELEMS", elems)
        got = kmp.minplus_ref(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), want)


def test_minplus_propagates_nan_as_jnp_min_does():
    a, b = _minplus_inputs(16, 8, 16, 7)
    a[3, 2] = np.nan
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(ref.minplus(a, b))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.ones((4, 4))
    before = dict(km.launches)
    ops.matmul(x.half(), x.half())                     # the tensor-core route's inputs
    ops.matmul(x, x)
    ops.matmul_acc(x.half(), x.half(), x.clone())
    ops.matmul_acc(x, x, x.clone())
    c16 = x.half()
    assert ops.matmul_acc(x, x, c16) is c16            # an f16 C, as the reference takes
    np.testing.assert_array_equal(c16.float().numpy(), np.full((4, 4), 5.0))
    assert km.launches == before                       # the CPU runs the plain versions
    assert set(km.launches) == {f"{op}_{dt}_{tile}" for op in ("matmul", "matmul_acc")
                                for dt, tile in (("f16", "wgmma"), ("f32", "ffma"),
                                                 ("f16", "simt"), ("f32", "simt"))}
    with pytest.raises(ValueError):
        ops.matmul(x, torch.ones((5, 4)))
    with pytest.raises(TypeError):
        ops.matmul(x.double(), x.double())
    with pytest.raises(TypeError):
        ops.matmul_acc(x, x, x.double())
    with pytest.raises(TypeError):
        ops.minplus(x.half(), x.half())
    with pytest.raises(ValueError):          # neither all on the CPU nor on one card
        km.matmul(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError):
        km.matmul(x.half().to("meta"), x.half().to("meta"))


@pytest.mark.parametrize("dtype,want", [(torch.float16, "wgmma"), (torch.float32, "ffma")])
def test_route_by_dtype(dtype, want):
    """A view TMA reads goes by its dtype: f16 to the tensor-core kernel, f32
    to the TMA-fed CUDA-core tile (IEEE f32, no TF32); C's dtype never
    changes the route."""
    name = {torch.float16: "f16", torch.float32: "f32"}[dtype]
    for op in ("matmul", "matmul_acc"):
        for out in (torch.float32, torch.float16):
            assert km._route(op, dtype, out, True) == f"{op}_{name}_{want}"
            assert km._route(op, dtype, out, False) == f"{op}_{name}_simt"


@pytest.mark.parametrize("op", ["matmul", "matmul_acc"])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float16, torch.float32), (torch.float16, torch.float16),
    (torch.float32, torch.float32), (torch.float32, torch.float16)])
@pytest.mark.parametrize("aligned", [True, False])
def test_route_table(op, in_dtype, out_dtype, aligned):
    """The route of every (op, input dtype, C dtype, alignment): one kernel,
    one launch counter, decided from these four alone."""
    tile = ("wgmma" if in_dtype == torch.float16 else "ffma") if aligned else "simt"
    want = f"{op}_{'f16' if in_dtype == torch.float16 else 'f32'}_{tile}"
    assert km._route(op, in_dtype, out_dtype, aligned) == want
    assert want in km.launches


def test_route_rejects_what_no_kernel_takes():
    for args in (("minplus", torch.float32, torch.float32, True),
                 ("matmul", torch.bfloat16, torch.float32, True),
                 ("matmul_acc", torch.float32, torch.float64, False)):
        with pytest.raises(TypeError):
            km._route(*args)


@pytest.mark.parametrize("shape,strides,address,ok", [
    ((64, 64), (64, 1), 0x1000, True),       # contiguous, 128-byte rows
    ((1000, 520), (520, 1), 0x7f00, True),   # the ragged case: 1040-byte rows
    ((64, 63), (64, 1), 0x1000, True),       # a column panel of a wider matrix
    ((1, 7), (7, 1), 0x1000, True),          # one row: no row stride to meet
    ((64, 63), (64, 1), 0x1002, False),      # x[:, 1:] of a 16-byte aligned matrix
    ((64, 12), (12, 1), 0x1000, False),      # 24-byte rows
    ((8, 1), (1, 1), 0x1000, False),         # K = 1: 2-byte rows
])
def test_tma_alignment_check(shape, strides, address, ok):
    """TMA reads a matrix whose base is 16-byte aligned and whose row stride
    is a multiple of 16 bytes; anything else goes to the SIMT tile."""
    assert km.tma_aligned(shape, strides, address, 2) is ok
    assert km._route("matmul", torch.float16, torch.float32, ok) == \
        ("matmul_f16_wgmma" if ok else "matmul_f16_simt")


def test_tma_alignment_of_views():
    """The same predicate on real f16 views: a slice one column in is
    misaligned, a column panel at a multiple of 8 columns is not."""
    blk = torch.zeros((16, 64), dtype=torch.float16)

    def aligned(t):
        return km.tma_aligned(t.shape, t.stride(), t.data_ptr(), t.element_size())

    assert aligned(blk[:, 8:40])
    assert not aligned(blk[:, 1:])


@pytest.mark.parametrize("dtype,route,counter", [
    (torch.float32, "ffma", "matmul_acc_f32_ffma"),
    (torch.float16, "wgmma", "matmul_acc_f16_wgmma"),
])
def test_matmul_acc_route_and_counter(dtype, route, counter):
    """matmul_acc of views TMA reads goes to the TMA-fed CUDA-core tile (f32,
    IEEE) or the tensor-core tile (f16 inputs, f32 C: SUMMA's panel steps),
    each counted under its own key; the misaligned views to the SIMT tile,
    counted apart."""
    assert km._route("matmul_acc", dtype, torch.float32, True) == counter
    assert counter.endswith(route) and counter in km.launches
    simt = counter.replace(route, "simt")
    assert km._route("matmul_acc", dtype, torch.float32, False) == simt
    assert simt in km.launches


def _panel_views(n: int = 8192, dtype=torch.float32):
    """The (A, B) operands that the bodies hand to ``mm_acc`` at size n, as
    each body slices its blocks (meta tensors: addresses from offsets, no
    storage): SUMMA and Cannon on 2x4 (panels of width n/4 of the (n/2,
    n/4) blocks), pipelined SUMMA on 1x8 (panels of width n/8), 2.5D Cannon
    on 2x2x2 (whole (n/2, n/2) blocks)."""
    def blk(r, c):
        return torch.empty((r, c), device="meta", dtype=dtype)
    views = []
    for name, (ar, ac), (br, bc), L, qx, qy in (
            ("summa/cannon 2x4", (n // 2, n // 4), (n // 2, n // 4), 4, 2, 4),
            ("pipelined 1x8", (n, n // 8), (n, n // 8), 8, 1, 8)):
        a_blk, b_blk = blk(ar, ac), blk(br, bc)
        w = ac // (L // qy)
        views += [(f"{name} A panel {s}", a_blk[:, s * w:(s + 1) * w]) for s in range(L // qy)]
        views += [(f"{name} B panel {s}", b_blk[s * w:(s + 1) * w, :]) for s in range(L // qx)]
    views += [("2.5D block", blk(n // 2, n // 2))]
    return views


def _aligned(t):
    return km.tma_aligned(t.shape, t.stride(), t.data_ptr(), t.element_size())


def test_matmul_acc_alignment_of_the_bodies_panel_views():
    """Every operand view of the distributed bodies at n = 8192, in f32 and
    in f16 (the f16 SUMMA run), is one TMA reads, so each panel step goes to
    the TMA-fed tile; a view one or two columns off a 16-byte boundary, or
    with a row stride off one, goes to the SIMT tile, decided before any
    launch."""
    for dtype, name, tile in ((torch.float32, "f32", "ffma"), (torch.float16, "f16", "wgmma")):
        views = _panel_views(dtype=dtype)
        assert len(views) == 1 + 2 + 1 + 8 + 1
        for _, t in views:
            assert _aligned(t)
        assert km._route("matmul_acc", dtype, torch.float32, True) == \
            f"matmul_acc_{name}_{tile}"
        a_blk = torch.empty((4096, 2048), device="meta", dtype=dtype)
        wide = torch.empty((64, 1030), device="meta", dtype=dtype)[:, :1024]  # rows off 16 B
        for t in (a_blk[:, 1:1025], a_blk[:, 2:1026], wide):
            assert not _aligned(t)
            assert km._route("matmul_acc", dtype, torch.float32, _aligned(t)) == \
                f"matmul_acc_{name}_simt"


# the reference's shapes that TMA cannot read, through the plain versions
# (what the SIMT route computes on the card) against the Pallas kernels in
# interpret mode; the reference clamps its blocks to these dims

def test_matmul_f16_on_24_byte_rows_matches_pallas():
    rng = np.random.RandomState(11)
    a, b = rng.randn(64, 12).astype(np.float16), rng.randn(12, 64).astype(np.float16)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert not _aligned(at)
    got = ops.matmul(at, bt)
    for want in (jops.matmul(jnp.asarray(a), jnp.asarray(b), interpret=True),
                 ref.matmul(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-1)


def test_matmul_acc_f32_at_250_cubed_matches_pallas():
    rng = np.random.RandomState(12)
    a, b, c = (rng.randn(250, 250).astype(np.float32) for _ in range(3))
    at = torch.from_numpy(a)
    assert not _aligned(at)                   # 1000-byte rows
    want = jops.matmul_acc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), interpret=True)
    ct = torch.from_numpy(c.copy())
    got = ops.matmul_acc(at, torch.from_numpy(b), ct)
    assert got.data_ptr() == ct.data_ptr()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("in_dtype", [np.float16, np.float32])
def test_matmul_acc_f16_c_matches_pallas(in_dtype):
    """An f16 C: seeded as f32, summed in f32, rounded once to f16, in C's
    storage, as ``_matmul_acc_kernel`` does with ``out_dtype=c.dtype``."""
    rng = np.random.RandomState(13)
    a, b = rng.randn(128, 96).astype(in_dtype), rng.randn(96, 64).astype(in_dtype)
    c = rng.randn(128, 64).astype(np.float16)
    want = jops.matmul_acc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), bm=64, bn=64,
                           bk=32, interpret=True)
    assert want.dtype == jnp.float16
    ct = torch.from_numpy(c.copy())
    got = ops.matmul_acc(torch.from_numpy(a), torch.from_numpy(b), ct)
    assert got is ct and got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-1)


def test_matmul_acc_f16_inputs_f32_c_matches_pallas():
    """SUMMA's panel step with f16 blocks: f16 A and B into an f32 C."""
    rng = np.random.RandomState(14)
    a, b = rng.randn(128, 64).astype(np.float16), rng.randn(64, 96).astype(np.float16)
    c = rng.randn(128, 96).astype(np.float32)
    want = jops.matmul_acc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), bm=64, bn=32,
                           bk=32, interpret=True)
    ct = torch.from_numpy(c.copy())
    got = ops.matmul_acc(torch.from_numpy(a), torch.from_numpy(b), ct)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-1)
