"""Flash attention: the CUDA kernels' wrapper and its plain version.

``flash_attention`` is the model's full-sequence attention (``forward`` and
the fused prefill of the end-aligned engine, ``models/layers.py``).  For
tensors on the card it launches a hand-written Hopper kernel of
``csrc/flash_attention.cu`` or raises; for tensors on the CPU it runs
``flash_attention_ref``, the plain PyTorch version; for ``meta`` tensors
(the dry run, ``launch/dryrun.py``) it returns an empty output and adds the
kernel's work to the dry run's tally (``_meta_rule``).  Nothing else selects
the path, and no failure falls back to another kernel or to the plain
version.

Which kernel, by dtypes and head size alone (``_route``):
  bf16 q, k and v with hd 64 or 128 -> "wgmma": the tensor-core kernel
      (TMA-fed K/V tiles, wgmma for Q.K^T and for P.V with P split into two
      bf16 terms, so P.V keeps the reference's f32 arithmetic); counted in
      ``launches_wgmma``;
  everything else (f32/f32, f32/bf16, other bf16 head sizes) -> "simt":
      IEEE f32 on the CUDA cores; counted in ``launches``.

Layouts are the JAX package's: q (B, Hq, Lq, D); k, v (B, Hkv, Lk, D) with
Hq % Hkv == 0 (query head h reads kv head h // (Hq / Hkv)); queries aligned
to the end of the keys (query row i sits at key position i + Lk - Lq).  The
kernel takes any element strides for batch, head and position (the last dim
contiguous), so the model passes transposed views of its (B, L, H, D)
tensors without copying them.  The output has q's dtype; the kernel's is a
(B, Hq, Lq, D) view of a (B, Lq, Hq, D) tensor, the model's own layout.

The kernels and the plain version compute what
``kernels/ref.py::flash_attention`` computes: f32 scores and softmax, P.V in
f32, one cast to q's dtype at the end.  The CUDA-core kernel scales q in f32
before the product, as the Pallas kernel does; the tensor-core kernel scales
the f32 scores, as the reference does (never a bf16-rounded q * scale), and
adds P.V as bf16(P).V + bf16(P - bf16(P)).V, which keeps P to about 2^-16
of itself (shown on a PyTorch model of that arithmetic; the kernel's bf16
output rounds away the difference from a single bf16 P).  In f32 they differ from the reference in summation order only
(1e-5), in bf16 by that, the split's remainder and the one output rounding.
A query row that sees no key gives 0 in all of them, row by row (the
reference gives NaN there).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import _build, _meta

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# what the kernel is built for: (q, k/v) dtypes, head size, shared memory
_KERNEL_DTYPES = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                  (torch.float32, torch.bfloat16)}
_BQ = _BKV = 64
_MAX_SMEM = 227 * 1024
_REF_SCORE_ELEMS = 2 ** 28     # the plain version's score block: 1 GiB of f32

launches = 0          # CUDA-core kernel launches; ``chip_smoke.py`` resets and reads it
launches_wgmma = 0    # tensor-core kernel launches, likewise


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch attention, ``ref.flash_attention``'s arithmetic: f32
    scores times ``scale``, -inf on masked keys, f32 softmax and P.V, output
    in q's dtype; a row with no visible key gives 0.  Query rows are taken
    in blocks whose f32 scores stay within ``_REF_SCORE_ELEMS`` (rows are
    independent, so the blocking changes no number)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(lk, device=q.device)
    step = max(1, _REF_SCORE_ELEMS // max(1, b * hq * lk))
    outs = []
    for lo in range(0, lq, step):
        hi = min(lq, lo + step)
        qg = q[:, :, lo:hi].float().reshape(b, hkv, rep, hi - lo, d)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kf) * scale
        qpos = torch.arange(lo, hi, device=q.device) + (lk - lq)
        mask = torch.ones((hi - lo, lk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        p = torch.where(mask.any(dim=-1)[:, None], p, torch.zeros((), device=q.device))
        outs.append(torch.einsum("bgrqk,bgkd->bgrqd", p, vf).reshape(b, hq, hi - lo, d))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out.to(q.dtype)


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, Lq, D) and equal k, v (B, Hkv, Lk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         f"(same B and D, Hq a multiple of Hkv)")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"q and k/v must be bfloat16 or float32 (k, v alike); got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _route(q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int) -> str:
    """The kernel that ``flash_attention`` launches: "wgmma" (tensor cores)
    for bf16 q and k/v with a head size of 64 or 128, else "simt"."""
    if q_dtype == kv_dtype == torch.bfloat16 and hd in (64, 128):
        return "wgmma"
    return "simt"


def _smem_bytes(hd: int) -> int:
    dmax = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return 4 * (dmax * _BQ + 2 * dmax * _BKV + _BQ * (_BKV + 4))


def visible_pairs(lq: int, lk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the mask leaves visible, queries end-aligned to
    the keys (row i at key position i + lk - lq)."""
    qpos = np.arange(lq, dtype=np.int64) + (lk - lq)
    hi = np.minimum(qpos, lk - 1) if causal else np.full(lq, lk - 1, dtype=np.int64)
    lo = np.zeros(lq, dtype=np.int64) if window is None else np.maximum(qpos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _meta_rule(q, k, v, causal, window) -> torch.Tensor:
    """The dry run's rule on ``meta`` tensors: an empty output laid out as
    the kernel's (a (B, Hq, Lq, D) view of a (B, Lq, Hq, D) tensor), and the
    kernel's work added to the active tally (``kernels/_meta.py``): 4·D
    FLOPs a visible (query, key) pair and head (Q·Kᵀ and P·V), q, k, v read
    once and the output written once.  No kernel runs and no counter moves."""
    b, hq, lq, hd = q.shape
    lk = k.shape[2]
    out = torch.empty((b, lq, hq, hd), dtype=q.dtype, device="meta").transpose(1, 2)
    flops = 4 * hd * b * hq * visible_pairs(lq, lk, causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    _meta.record(f"flash_attention_{_route(q.dtype, k.dtype, hd)}", flops, nbytes)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention with queries aligned to the end of the keys: the route's
    CUDA kernel for tensors on the card, the plain version on the CPU, the
    dry run's meta rule (``_meta_rule``) on ``meta`` tensors."""
    global launches, launches_wgmma
    _check(q, k, v, window)
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if all(t.device.type == "meta" for t in tensors):
        return _meta_rule(q, k, v, causal, window)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention takes tensors all on the CPU or all on one "
                         f"CUDA device; got {[str(t.device) for t in tensors]}")
    b, hq, lq, hd = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if (q.dtype, k.dtype) not in _KERNEL_DTYPES or hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"the kernel takes (q, k/v) dtypes bf16/bf16, f32/f32 or f32/bf16 "
                         f"and a head size that is a multiple of 8 up to 256; got "
                         f"{q.dtype}/{k.dtype}, D={hd}")
    if _smem_bytes(hd) > _MAX_SMEM:
        raise ValueError(f"the kernel's tiles need {_smem_bytes(hd)} B of shared memory, "
                         f"more than {_MAX_SMEM}")
    out = torch.empty((b, lq, hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1:
            raise ValueError(f"the kernel takes a contiguous last dim; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
        # 8-element chunks are read as 16-byte vectors, and TMA wants
        # 16-byte bases and strides
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"the kernel takes 16-byte aligned tensors whose batch, head "
                             f"and position strides are multiples of 8 elements; got "
                             f"strides {t.stride()} at address {t.data_ptr():#x}")
        strides += list(t.stride()[:3])
    wgmma = _route(q.dtype, k.dtype, hd) == "wgmma"
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_wgmma if wgmma else lib.repro_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * (0 if wgmma else 2) + [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    c_strides = (ctypes.c_longlong * 12)(*strides)
    codes = () if wgmma else (_DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype])
    err = fn(*codes, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(c_strides), b, hq, hkv, lq, lk, hd, int(causal),
             0 if window is None else int(window),
             scale if scale is not None else 1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {'wgmma' if wgmma else 'simt'} kernel launch "
                           f"failed: {lib.repro_cuda_error_string(err).decode()} ({err})")
    if wgmma:
        launches_wgmma += 1
    else:
        launches += 1
    return out
