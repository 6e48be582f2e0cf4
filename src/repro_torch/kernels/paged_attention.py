"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

``paged_attention`` is the model decode path's entry (``models/layers.py``).
For tensors on the card it launches the hand-written Hopper kernel in
``csrc/paged_attention.cu`` or raises; for tensors on the CPU it runs
``paged_attention_ref``, the plain PyTorch version.  Nothing else selects the
path, and no failure falls back to the plain version.

Layouts are the JAX package's: q (B, Hkv, rep, hd); arenas (N, block, Hkv,
hd); block_tables (B, P) int32 with -1 for an unallocated entry; lengths (B,)
int32 valid tokens per request.  The output has q's dtype.

The kernel splits each row's table into S ranges of ``pps`` pages
(``split_plan``: from B, Hkv, P and the card's SM count, never from the
lengths, which would sync the stream), writes each split's partial softmax
state to an f32 workspace and combines the splits in a second small launch;
one wrapper call counts as one launch.

The two versions round at different places, as the TPU kernel and its jnp
reference do.  The kernel follows the Pallas kernel: q scaled in f32, P.V in
f32.  The plain version follows the reference: q scaled in q's dtype and the
probabilities cast to q's dtype before P.V (the model's ``_sdpa``
discipline).  In f32 the two agree to 1e-5; in bf16 they differ by about one
bf16 rounding of the probabilities and of q * scale, which
``atol = rtol = 2e-2`` covers.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# what the kernel is built for: (q, arena) dtypes, and the GQA group sizes
# (Hq / Hkv) of the repository's archs
_KERNEL_DTYPES = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                  (torch.float32, torch.bfloat16)}
_KERNEL_REPS = (1, 2, 3, 4, 6, 8, 12, 16)

launches = 0          # wrapper calls on the card; ``chip_smoke.py`` resets and reads it

# the kernel's block: 4 warps, each with a 3-stage ring of (K, V) chunks
_WARPS, _STAGES = 4, 3
_SMEM_LIMIT = 227 * 1024


def split_plan(batch: int, hkv: int, pages: int, n_sm: int) -> tuple:
    """(S, pps): the kernel's grid is (batch, hkv, S), split s taking table
    pages [s * pps, (s + 1) * pps).  At least two blocks an SM where the
    table allows it (S = 1 once batch * hkv >= 2 * n_sm); pps is rounded up,
    and S re-derived from it so that no split is past the table.  It reads
    shapes only: the lengths stay on the card."""
    if batch * hkv >= 2 * n_sm:
        return 1, pages
    s = min(pages, -(-2 * n_sm // (batch * hkv)))
    pps = -(-pages // s)
    return -(-pages // pps), pps


def kernel_takes(q_dtype: torch.dtype, kv_dtype: torch.dtype, rep: int, hd: int) -> bool:
    """Whether the kernel is built for these (q, arena) dtypes, this GQA
    group and this head size (at most 256, in 16-byte K/V rows)."""
    return ((q_dtype, kv_dtype) in _KERNEL_DTYPES and rep in _KERNEL_REPS and hd <= 256
            and hd * kv_dtype.itemsize % 16 == 0)


def _variant(q_dtype: torch.dtype, kv_dtype: torch.dtype, rep: int, hd: int) -> tuple:
    """The macros that build only the instantiation a launch takes: the
    (q, arena) dtype codes, the group and the lanes of a token (16 for
    hd <= 128, else 32)."""
    return (("REPRO_PA_Q", _DTYPE_CODE[q_dtype]), ("REPRO_PA_KV", _DTYPE_CODE[kv_dtype]),
            ("REPRO_PA_REP", rep), ("REPRO_PA_G", 16 if hd <= 128 else 32))


def _smem_bytes(rep: int, hd: int, kv_bytes: int, pps: int) -> int:
    """The split block's dynamic shared memory (``smem_bytes`` in the
    source): table entries, the warps' rings of 2 KB K and V chunks, and
    the warps' (m, l, acc) states."""
    g = 16 if hd <= 128 else 32                    # lanes of a token
    chunk_tokens = 32 // g * (8 // kv_bytes)
    return (-(-4 * pps // 16) * 16 + _WARPS * _STAGES * 2 * chunk_tokens * hd * kv_bytes
            + 4 * _WARPS * rep * (hd + 2))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch paged decode attention.

    Follows the JAX reference (``kernels/ref.py::paged_attention``): gather
    the pages through the clamped table, f32 scores of ``q * scale`` (scaled
    in q's dtype; ``scale`` defaults to 1/sqrt(hd), as
    ``paged_attention_pallas``'s), f32 softmax, probabilities cast to q's
    dtype for P.V.
    Key positions at or past the length are masked; so are positions on a
    dead (-1) table entry, and a row with no live key returns 0 -- the TPU
    kernel's semantics, which the reference leaves to the kernel.  Wherever
    every page below the length is live (every row the decode path reads),
    the result is the reference's."""
    b, hkv, rep, hd = q.shape
    blk = k_pages.shape[1]
    p = block_tables.shape[1]
    idx = block_tables.long().clamp(min=0)
    k = k_pages[idx].reshape(b, p * blk, hkv, hd)
    v = v_pages[idx].reshape(b, p * blk, hkv, hd)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bgrd,bkgd->bgrk", (q * scale).float(), k.float())
    kpos = torch.arange(p * blk, device=q.device)
    live = (block_tables >= 0).repeat_interleave(blk, dim=1)      # (B, K)
    mask = (kpos[None, :] < lengths.long()[:, None]) & live
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", probs, v.to(q.dtype))
    return torch.where(mask.any(dim=1)[:, None, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _check(q, k_pages, v_pages, block_tables, lengths) -> None:
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"need q (B, Hkv, rep, hd) and equal (N, block, Hkv, hd) "
                         f"arenas; got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, hkv, _, hd = q.shape
    if (k_pages.shape[2], k_pages.shape[3]) != (hkv, hd):
        raise ValueError(f"arena (N, block, Hkv, hd) {tuple(k_pages.shape)} does not "
                         f"match q's Hkv={hkv}, hd={hd}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            tuple(lengths.shape) != (b,):
        raise ValueError(f"need block_tables (B, P) and lengths (B,) for B={b}; got "
                         f"{tuple(block_tables.shape)}, {tuple(lengths.shape)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"block_tables and lengths must be int32; got "
                        f"{block_tables.dtype}, {lengths.dtype}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE or \
            v_pages.dtype != k_pages.dtype:
        raise TypeError(f"q and the arenas must be bfloat16 or float32 (arenas "
                        f"alike); got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Paged decode attention, scores scaled by ``scale`` (default
    1/sqrt(hd)): the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU."""
    global launches
    _check(q, k_pages, v_pages, block_tables, lengths)
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, scale=scale)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"paged_attention takes tensors all on the CPU or all on one "
                         f"CUDA device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged_attention kernel takes contiguous tensors only")
    b, hkv, rep, hd = q.shape
    n_blocks, blk, pages = k_pages.shape[0], k_pages.shape[1], block_tables.shape[1]
    n_splits, pps = split_plan(b, hkv, pages, _sm_count(q.device.index or 0))
    smem = _smem_bytes(rep, hd, k_pages.element_size(), pps)
    if not kernel_takes(q.dtype, k_pages.dtype, rep, hd) or smem > _SMEM_LIMIT:
        raise ValueError(f"the kernel takes (q, arena) dtypes in bf16/bf16, f32/f32, "
                         f"f32/bf16, rep in {_KERNEL_REPS}, hd <= 256 with 16-byte K/V "
                         f"rows, and at most 227 KB of shared memory; got {q.dtype}/"
                         f"{k_pages.dtype}, rep={rep}, hd={hd}, {pps} pages a split "
                         f"({smem} B)")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned K/V arenas")
    out = torch.empty_like(q)
    # each split's acc, then its (m, l), in f32; none when one split writes out
    ws = torch.empty(b * hkv * n_splits * rep * (hd + 2), dtype=torch.float32,
                     device=q.device) if n_splits > 1 else None
    lib = _build.load("paged_attention", _variant(q.dtype, k_pages.dtype, rep, hd))
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
             b, hkv, rep, hd, n_blocks, blk, pages, pps,
             1.0 / math.sqrt(hd) if scale is None else scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out
