"""Grouped expert products of an MoE layer: the CUDA kernels' wrappers and
their plain versions.

``grouped_gate_up(xs, w_gate, w_up, offsets)`` gives h = silu(xs_g . W_gate[e])
* (xs_g . W_up[e]) and ``grouped_down(h, w_down, offsets)`` gives h_g .
W_down[e], where group e is rows ``offsets[e]:offsets[e + 1]`` of rows sorted
by expert (``models/moe.py``).  ``offsets`` holds E + 1 int32 on the rows'
device, non-decreasing from 0 and at most the number of rows; rows at or past
``offsets[E]`` give 0, as ``lax.ragged_dot`` gives them.  Both sum in f32 and
round once to the rows' dtype: the gate and up sums never leave f32.  Given
``slots`` and ``scale``, ``grouped_down`` also does the MoE combine's put and
weighting (``scatter``) in its epilogue.

For tensors on the card each launches one hand-written Hopper kernel of
``csrc/grouped_matmul.cu`` or raises; for tensors on the CPU each runs its
plain version (``*_ref``).  No failure falls back to another path.  The
kernels replace no TPU kernel: they stand in for the reference's
``lax.ragged_dot`` (``src/repro/models/moe.py:100-105``), which the port had
run as one ``torch.matmul`` per expert and projection, bounded by group sizes
read back to the host.  Here the bounds stay on the device: each block reads
them, so a layer call neither syncs nor loops on the host.  What bounds them
on this card is in the source: the experts' bytes at decode and at
Mellum2's prefill, the operations at Mixtral's prefill.  Neither kernel
has a backward: the layer takes them only where autograd records nothing
(``models/moe.py::_on_loop``).

The row tile (``row_tile``) comes from what the host knows without a sync:
the mean rows an expert.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import torch
import torch.nn.functional as F

from . import _build

# kernel launches (each gate+up and each down call counts one);
# chip_smoke.py resets and reads it
launches = 0
_ROW_TILES = (8, 16, 32, 64, 128)


def row_tile(rows: int, groups: int) -> int:
    """The kernels' row tile: the smallest of 8, 16, ..., 128 that holds
    twice the mean rows a group, so an expert's rows fit one tile (and its
    matrices are read once) unless it gets more than twice its share."""
    want = 2 * rows / max(1, groups)
    return next((t for t in _ROW_TILES if t >= want), _ROW_TILES[-1])


def ragged_dot(xs: torch.Tensor, w: torch.Tensor, sizes: List[int],
               acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lax.ragged_dot`` on sizes the host knows, one ``torch.matmul`` per
    expert: rows of ``xs`` in consecutive groups of ``sizes``, group e times
    ``w[e]`` cast to the rows' dtype (an expert at a time), summed and
    returned in ``acc`` (by default the rows' dtype); rows past the groups'
    sum give 0.  The one plain version of the grouped products: the
    kernels' plain versions and the layer's per-expert loop are built on
    it."""
    acc = acc or xs.dtype
    outs, lo = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(torch.matmul(xs[lo:lo + n].to(acc), w[e].to(xs.dtype).to(acc)))
            lo += n
    if lo < xs.shape[0] or not outs:
        outs.append(xs.new_zeros((xs.shape[0] - lo, w.shape[-1]), dtype=acc))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def ragged_swiglu(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """The reference's grouped SwiGLU (``src/repro/models/moe.py:100-105``)
    as the per-expert loop the kernels replace: g and u rounded to the rows'
    dtype, silu(g) taken in f32 and rounded, times u, then the down
    product.  The layer's route where the kernels do not run
    (``models/moe.py::_on_loop``)."""
    g = ragged_dot(xs, w_gate, sizes)
    u = ragged_dot(xs, w_up, sizes)
    return ragged_dot(F.silu(g.float()).to(xs.dtype) * u, w_down, sizes)


def _sizes(offsets: torch.Tensor) -> List[int]:
    return torch.diff(offsets).tolist()


def grouped_gate_up_ref(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of ``grouped_gate_up``: each group's two products in
    f32 (weights cast to the rows' dtype first, as the layer casts them),
    silu(g) * u rounded once to the rows' dtype; other rows 0."""
    sizes = _sizes(offsets)
    g = ragged_dot(xs, w_gate, sizes, torch.float32)
    u = ragged_dot(xs, w_up, sizes, torch.float32)
    return (F.silu(g) * u).to(xs.dtype)


def grouped_down_ref(h: torch.Tensor, w_down: torch.Tensor, offsets: torch.Tensor,
                     slots: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``grouped_down``: each group's product in f32,
    rounded once to h's dtype; other rows 0; with ``slots``, ``scatter``
    of that."""
    y = ragged_dot(h, w_down, _sizes(offsets), torch.float32).to(h.dtype)
    return y if slots is None else scatter(y, slots, scale)


def scatter(y: torch.Tensor, slots: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(len(scale), d) f32 whose row slots[r] is y[r] widened to f32 times
    scale[slots[r]], rows not listed 0: a put (out of place, no atomics),
    each slot listed at most once."""
    rows = y.float() * scale.index_select(0, slots)[:, None]
    return rows.new_zeros((scale.shape[0], y.shape[1])).index_put((slots,), rows)


def takes(xs: torch.Tensor, *ws: torch.Tensor) -> bool:
    """Whether the kernels take rows ``xs`` and expert matrices ``ws`` on
    the card: bf16 alike, xs a matrix with unit inner stride and a row
    stride of a multiple of 8, each weight a dense (E, K, M) on xs's device
    with K and M multiples of 8 (TMA reads 16-byte aligned rows)."""
    return (xs.is_cuda and xs.dtype == torch.bfloat16 and xs.dim() == 2
            and xs.stride(1) == 1 and xs.stride(0) % 8 == 0 and xs.data_ptr() % 16 == 0
            and all(w.dtype == xs.dtype and w.device == xs.device and w.dim() == 3
                    and w.is_contiguous() and w.shape[1] % 8 == 0 and w.shape[2] % 8 == 0
                    and w.data_ptr() % 16 == 0 for w in ws))


def _check(name: str, xs, ws, offsets, extra=()) -> bool:
    """Shapes; then True for tensors on one CUDA device that the kernel
    takes, False for tensors all on the CPU; raises for anything else."""
    e, k = ws[0].shape[:2]
    if xs.dim() != 2 or xs.shape[1] != k or any(w.shape != ws[0].shape for w in ws):
        raise ValueError(f"{name}: need rows (R, K) and matrices (E, K, M) alike; got "
                         f"{tuple(xs.shape)}, {[tuple(w.shape) for w in ws]}")
    if offsets.shape != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"{name}: need offsets of E + 1 = {e + 1} int32; got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    tensors = (xs, offsets, *ws, *extra)
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if not takes(xs, *ws) or any(t.device != xs.device for t in (offsets, *extra)):
        raise ValueError(f"the {name} kernel takes bf16 rows (unit inner stride, row stride "
                         f"a multiple of 8) and dense bf16 (E, K, M) matrices with K and M "
                         f"multiples of 8, offsets on the same CUDA device; got "
                         f"{[(str(t.device), t.dtype, tuple(t.shape), t.stride()) for t in tensors]}")
    return True


def _launch(symbol: str, xs: torch.Tensor, ws, out: torch.Tensor, extra, offsets
            ) -> torch.Tensor:
    """One launch of ``symbol`` (C signature: xs, the weights, out, the
    ``extra`` pointers, offsets, rows, groups, K, M, ldx, bn, stream)."""
    global launches
    lib = _build.load("grouped_matmul")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (len(ws) + len(extra) + 3) + [ctypes.c_int] * 4 + \
            [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    rows, (e, k, m) = xs.shape[0], ws[0].shape
    err = fn(xs.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), *extra,
             offsets.data_ptr(), rows, e, k, m, xs.stride(0), row_tile(rows, e),
             torch.cuda.current_stream(xs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out


def grouped_gate_up(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """h (R, ff) = silu(xs_g . W_gate[e]) * (xs_g . W_up[e]) for each group e
    of rows ``offsets[e]:offsets[e + 1]``, 0 past ``offsets[E]``: one kernel
    launch on the card, the plain version on the CPU."""
    if not _check("grouped_gate_up", xs, (w_gate, w_up), offsets):
        return grouped_gate_up_ref(xs, w_gate, w_up, offsets)
    out = torch.empty((xs.shape[0], w_gate.shape[2]), dtype=xs.dtype, device=xs.device)
    if xs.shape[0] == 0:
        return out
    return _launch("repro_grouped_gate_up", xs, (w_gate, w_up), out, (), offsets)


def grouped_down(h: torch.Tensor, w_down: torch.Tensor, offsets: torch.Tensor,
                 slots: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (R, d) = h_g . W_down[e] for each group e, 0 past ``offsets[E]``;
    with ``slots`` (R distinct int64 in [0, len(scale)), unchecked: a check
    would read them back) and ``scale`` (f32), ``scatter(y, slots, scale)``,
    the MoE combine's put and weighting, written by the kernel's epilogue.  One kernel launch on the card, the plain version on
    the CPU."""
    if (slots is None) != (scale is None):
        raise ValueError("grouped_down takes slots and scale together")
    if slots is not None and (slots.shape != (h.shape[0],) or slots.dtype != torch.int64
                              or scale.dim() != 1 or scale.dtype != torch.float32
                              or not slots.is_contiguous() or not scale.is_contiguous()):
        raise ValueError(f"grouped_down: need slots ({h.shape[0]},) int64 and scale (n,) f32, "
                         f"both contiguous; got {tuple(slots.shape)} {slots.dtype}, "
                         f"{tuple(scale.shape)} {scale.dtype}")
    extra = () if slots is None else (slots, scale)
    if not _check("grouped_down", h, (w_down,), offsets, extra):
        return grouped_down_ref(h, w_down, offsets, slots, scale)
    d = w_down.shape[2]
    if slots is None:
        out = torch.empty((h.shape[0], d), dtype=h.dtype, device=h.device)
    else:   # every slot is written when the rows list them all
        make = torch.empty if h.shape[0] == scale.shape[0] else torch.zeros
        out = make((scale.shape[0], d), dtype=torch.float32, device=h.device)
    if h.shape[0] == 0:
        return out
    return _launch("repro_grouped_down", h, (w_down,), out,
                   (0, 0) if slots is None else (slots.data_ptr(), scale.data_ptr()), offsets)
