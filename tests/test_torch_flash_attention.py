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
    before = fa.launches
    fa.flash_attention(q, k, v)
    assert fa.launches == before                  # the CPU runs the plain version
    with pytest.raises(ValueError, match="all on the CPU or all on one CUDA"):
        fa.flash_attention(q, k.to("meta"), v)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q.half(), k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
