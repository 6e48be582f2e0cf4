"""Port's flash-attention wrapper and plain version against the JAX package's
kernel and oracle.

The same numpy inputs go through ``repro.kernels.ref.flash_attention``, the
Pallas kernel in interpret mode (``ops.flash_attention(interpret=True)``, as
``tests/test_kernels.py`` runs it) and the port's ``flash_attention``, which
runs its plain version on CPU tensors.  Tolerances: f32 1e-5 against the
oracle (summation order only); 2e-3 against the interpret-mode kernel, the
bound the JAX tests hold that kernel to; bf16 5e-2 (one bf16 rounding of the
output, and the oracle's bf16 einsum inputs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

SHAPES = [
    (1, 4, 2, 256, 256, 64, True, None),     # GQA causal prefill
    (2, 2, 2, 128, 128, 32, False, None),    # MHA bidirectional
    (1, 4, 1, 256, 256, 64, True, 96),       # sliding window
    (1, 2, 1, 1, 256, 64, True, None),       # decode (1 query vs cache)
    (1, 8, 8, 128, 128, 128, True, None),    # hd=128
]


def _qkv(b, hq, hkv, lq, lk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, lq, d).astype(np.float32),
            rng.randn(b, hkv, lk, d).astype(np.float32),
            rng.randn(b, hkv, lk, d).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal,window", SHAPES)
def test_plain_matches_jax_oracle_and_interpret_kernel(b, hq, hkv, lq, lk, d, causal, window):
    q, k, v = _qkv(b, hq, hkv, lq, lk, d)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, interpret=True, bq=64, bkv=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("window", [None, 40])
def test_bf16_matches_jax(window):
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    # the same bf16 numbers on both sides
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    got = fa.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16
    for want in (jref.flash_attention(jq, jk, jv, window=window),
                 jops.flash_attention(jq, jk, jv, window=window, interpret=True,
                                      bq=64, bkv=64)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=5e-2, rtol=5e-2)


def test_mixed_f32_queries_over_bf16_keys():
    """(q, k/v) = f32/bf16, the f32 model over its bf16 cache: the same as
    f32 attention over the bf16 values widened."""
    q, k, v = _qkv(1, 4, 2, 40, 40, 32, seed=2)
    tq, tk, tv = _t(q, k, v)
    kb, vb = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    got = fa.flash_attention(tq, kb, vb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, fa.flash_attention(tq, kb.float(), vb.float()),
                               atol=0, rtol=0)


def test_rows_with_no_key_are_zero():
    """q (1, 2, 8, 16) over k/v (1, 1, 4, 16), causal: query rows 0-3 sit
    at negative key positions and see no key.  They are exactly 0, row by
    row (the JAX oracle gives NaN there, the Pallas kernel a tile-dependent
    value); rows 4-7 agree with the oracle."""
    q, k, v = _qkv(1, 2, 1, 8, 4, 16, seed=3)
    got = fa.flash_attention(*_t(q, k, v))
    assert torch.equal(got[:, :, :4], torch.zeros_like(got[:, :, :4]))
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert np.isnan(want[:, :, :4]).all()
    np.testing.assert_allclose(got[:, :, 4:].numpy(), want[:, :, 4:], atol=1e-5, rtol=1e-5)


def test_strided_model_layout_view_equals_contiguous_copy():
    """The model passes (B, L, Hkv, rep, hd) and (B, L, Hkv, hd) tensors as
    transposed (B, H, L, hd) views; the result equals that of contiguous
    copies, and the model layout comes back with one transpose."""
    rng = np.random.RandomState(4)
    b, L, hkv, rep, hd = 2, 19, 2, 3, 16
    q = torch.from_numpy(rng.randn(b, L, hkv, rep, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, L, hkv, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, L, hkv, hd).astype(np.float32))
    qv = q.reshape(b, L, hkv * rep, hd).transpose(1, 2)
    assert not qv.is_contiguous()
    got = fa.flash_attention(qv, k.transpose(1, 2), v.transpose(1, 2), window=7)
    want = fa.flash_attention(qv.contiguous(), k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), window=7)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    jwant = jref.flash_attention(jnp.asarray(qv.contiguous().numpy()),
                                 jnp.asarray(k.transpose(1, 2).contiguous().numpy()),
                                 jnp.asarray(v.transpose(1, 2).contiguous().numpy()),
                                 window=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-5, rtol=1e-5)


def test_wrapper_raises_and_counts_only_kernel_launches():
    q, k, v = _t(*_qkv(1, 2, 1, 8, 8, 16))
    before = (fa.launches, fa.launches_wgmma)
    fa.flash_attention(q, k, v)
    # bf16 with hd 64, the tensor-core route's inputs, on the CPU
    fa.flash_attention(*_t(*_qkv(1, 2, 1, 8, 8, 64), dtype=torch.bfloat16))
    assert (fa.launches, fa.launches_wgmma) == before   # the CPU runs the plain version
    with pytest.raises(ValueError, match="all on the CPU or all on one CUDA"):
        fa.flash_attention(q, k.to("meta"), v)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q.half(), k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)


def _tensor_core_arithmetic(q, k, v, *, causal, window, split=True):
    """The tensor-core kernel's arithmetic in PyTorch, on f32 tensors that
    hold bf16 values: 64-key tiles; f32 scores times scale * log2(e) (the
    scale is never folded into a bf16 q); the -inf mask with the no-key
    guard; exp2 online softmax in f32; and P.V as bf16(P).V + bf16(P -
    bf16(P)).V accumulated in f32 (``split=False``: a single bf16 P).  The
    row sum comes from the f32 P.  Returns f32, before the output cast."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    rep = hq // hkv
    kk, vv = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    scale2 = torch.tensor((1.0 / np.sqrt(d)) * np.log2(np.e), dtype=torch.float32)
    qpos = torch.arange(lq)[:, None] + (lk - lq)
    m = torch.full((b, hq, lq, 1), -np.inf)
    l = torch.zeros((b, hq, lq, 1))
    o = torch.zeros((b, hq, lq, d))
    for kb in range(0, lk, 64):
        ke = min(lk, kb + 64)
        x = torch.einsum("bhqd,bhkd->bhqk", q, kk[:, :, kb:ke]) * scale2
        kpos = torch.arange(kb, ke)[None, :]
        ok = torch.ones((lq, ke - kb), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        x = x.masked_fill(~ok, -np.inf)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -np.inf, torch.zeros(()), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        m = m_new
        p_hi = p.to(torch.bfloat16).float()
        vt = vv[:, :, kb:ke]
        o = o * alpha + p_hi @ vt
        if split:
            o = o + (p - p_hi).to(torch.bfloat16).float() @ vt
    return torch.where(l == 0, torch.zeros(()), o / torch.where(l == 0, torch.ones(()), l))


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal,window", [
    (1, 4, 2, 200, 200, 64, True, None),       # GQA causal, ragged last tile
    (1, 2, 1, 130, 130, 128, True, 50),        # hd 128, sliding window
    (2, 2, 2, 96, 96, 64, False, None),        # bidirectional
])
def test_split_pv_keeps_reference_arithmetic(b, hq, hkv, lq, lk, d, causal, window):
    """On bf16 values, the tensor-core kernel's split P.V agrees with JAX's
    ``ref.flash_attention`` (f32 P.V) at the f32 tolerance of 1e-5; a single
    bf16 P does not: it rounds P to 2^-8 of itself, the split to 2^-16."""
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in _qkv(b, hq, hkv, lq, lk, d, seed=5))
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window))
    tq, tk, tv = _t(q, k, v)
    got = _tensor_core_arithmetic(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    single = _tensor_core_arithmetic(tq, tk, tv, causal=causal, window=window, split=False)
    assert not np.allclose(single.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.abs(single.numpy() - want).max() > 10 * np.abs(got.numpy() - want).max()


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 32, 64, 96, 128, 256])
def test_route_by_dtypes_and_head_size(q_dtype, kv_dtype, hd):
    """bf16 q and k/v with hd 64 or 128 go to the tensor-core kernel, every
    other pair to the CUDA-core one."""
    want = ("wgmma" if q_dtype == kv_dtype == torch.bfloat16 and hd in (64, 128)
            else "simt")
    assert fa._route(q_dtype, kv_dtype, hd) == want
