"""Tiled matrix products: the CUDA kernels' wrappers and their plain versions.

``matmul(a, b)`` and ``matmul_acc(a, b, c)`` are the local block products of
the distributed matmul path (``core/dns_matmul.py``, ``core/summa.py``,
``core/summa_pipelined.py``).  For tensors on the card they launch a
hand-written Hopper kernel of ``csrc/matmul.cu`` or raise; for tensors on
the CPU they run ``matmul_ref`` / ``matmul_acc_ref``.  Nothing else selects
the path, and no failure falls back to another kernel or to the plain
version.

Which kernel (``_route``, from the inputs alone, before the launch): the op,
the input dtype, and whether TMA can read both A and B (``tma_aligned``: a
16-byte aligned base and a row stride of a multiple of 16 bytes).

  op          inputs  TMA reads A, B  kernel (= launch counter)
  matmul      f16     yes             "matmul_f16_wgmma"      tensor cores (wgmma)
  matmul      f32     yes             "matmul_f32_ffma"       CUDA cores, TMA-fed
  matmul      f16/32  no              "matmul_f16/f32_simt"   CUDA cores, element loads
  matmul_acc  f16     yes             "matmul_acc_f16_wgmma"  tensor cores (wgmma)
  matmul_acc  f32     yes             "matmul_acc_f32_ffma"   CUDA cores, TMA-fed
  matmul_acc  f16/32  no              "matmul_acc_f16/f32_simt"

C (``out_dtype`` of ``matmul``, ``c.dtype`` of ``matmul_acc``) is f32 or f16
on every route and never changes it: each kernel sums in f32 and rounds once
to C's type, as ``_matmul_kernel`` / ``_matmul_acc_kernel`` do (the latter
seeded with ``cin.astype(f32)``).  The reference clamps its blocks to any
shape, so every view of unit inner stride has a route; the SIMT tile takes
what TMA cannot read.

f32 stays IEEE f32 on the CUDA cores (no TF32: the reference's f32 bound of
1e-4 needs f32 products); products of f16 values are exact in f32, and the
tensor cores add them in f32 with truncation.  Every route is bound by its
2*m*n*k operations (``csrc/matmul.cu``): at 989 TFLOP/s on "wgmma", at the
CUDA cores' 67 TFLOP/s on "ffma" and "simt".  The plain versions rely on
PyTorch's default of ``torch.backends.cuda.matmul.allow_tf32 = False`` for
tensors on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1}
_MODE = {"matmul": 0, "matmul_acc": 1}           # the kernels' store / accumulate mode

# kernel launches by kernel (the names ``_route`` gives); chip_smoke.py
# resets and reads them
launches = dict.fromkeys((
    "matmul_f16_wgmma", "matmul_f32_ffma", "matmul_f16_simt", "matmul_f32_simt",
    "matmul_acc_f16_wgmma", "matmul_acc_f32_ffma", "matmul_acc_f16_simt", "matmul_acc_f32_simt"),
    0)
# None, or a list that each tile-kernel launch (matmul, matmul_acc, minplus)
# appends its (name, start, end) CUDA events to; chip_smoke.py sums their
# device time over a run
events = None


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation (``kernels/ref.py::matmul``)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_acc_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C += A @ B in c's storage, summed in f32 from c widened to f32 and
    rounded once to c's dtype (``_matmul_acc_kernel``); returns c."""
    if c.dtype == torch.float32:
        return c.addmm_(a.float(), b.float())
    return c.copy_(torch.addmm(c.float(), a.float(), b.float()))


def tma_aligned(shape, strides, address: int, element_size: int) -> bool:
    """Whether TMA can read a row-major matrix (``shape``, element
    ``strides``, base ``address``): a 16-byte aligned base and a row stride
    of a multiple of 16 bytes (a matrix of one row has no row stride to
    speak of)."""
    return address % 16 == 0 and (shape[0] <= 1 or strides[0] * element_size % 16 == 0)


def _route(op: str, in_dtype: torch.dtype, out_dtype: torch.dtype, aligned: bool) -> str:
    """The kernel that ``op`` ("matmul" or "matmul_acc") launches for A and B
    of ``in_dtype`` and C of ``out_dtype``, ``aligned`` when TMA reads both
    A and B: the tensor-core tile (f16) or the TMA-fed FFMA tile (f32) for
    aligned views, the SIMT tile for the rest.  The name is also the
    launch counter's key.  Raises for what no kernel takes."""
    if op not in _MODE or in_dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"no kernel for {op} with {in_dtype} inputs and a {out_dtype} C; "
                        f"the ops are matmul and matmul_acc, the dtypes f32 and f16")
    tile = ("wgmma" if in_dtype == torch.float16 else "ffma") if aligned else "simt"
    return f"{op}_{'f16' if in_dtype == torch.float16 else 'f32'}_{tile}"


def _check(a, b, c=None) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need A (m, k) and B (k, n); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if c is not None and tuple(c.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"need C (m, n) = {(a.shape[0], b.shape[1])}; got "
                         f"{tuple(c.shape)}")


def _on_card(name: str, *ts) -> bool:
    """True for tensors all on one CUDA device, False for tensors all on the
    CPU; raises for anything else."""
    if all(t.device.type == "cpu" for t in ts):
        return False
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name} takes tensors all on the CPU or all on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    for t in ts:
        if t.stride(1) != 1 or (t.shape[0] > 1 and t.stride(0) < t.shape[1]):
            raise ValueError(f"the {name} kernel takes row-major matrices with unit "
                             f"inner stride; got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
    return True


def launch_tile(lib_name: str, symbol: str, name: str, codes, a, b, c) -> None:
    """Launch one tile kernel of ``csrc/`` (C signature: ``codes..., a, b, c,
    m, n, k, lda, ldb, ldc, stream``) on the current stream; raises on a
    refused launch.  ``name`` keys the launch counter and the events."""
    lib = _build.load(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * len(codes) + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    stream = torch.cuda.current_stream(a.device)
    if events is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
    m, k = a.shape
    n = b.shape[1]
    err = fn(*codes, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
             a.stride(0), b.stride(0), c.stride(0), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} ({err})")
    if events is not None:
        end.record(stream)
        events.append((name, start, end))


def _launch(op: str, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    aligned = all(tma_aligned(t.shape, t.stride(), t.data_ptr(), t.element_size())
                  for t in (a, b))
    name = _route(op, a.dtype, c.dtype, aligned)
    # the tile's C entry in csrc/matmul.cu: repro_tile_wgmma, _ffma or _simt
    launch_tile("matmul", "repro_tile_" + name.rsplit("_", 1)[1], name,
                (_MODE[op], _DTYPE_CODE[a.dtype], _DTYPE_CODE[c.dtype]), a, b, c)
    launches[name] += 1


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B, f32 accumulation, cast to ``out_dtype`` (f32 or f16): the
    route's CUDA kernel for tensors on the card, the plain version on the
    CPU."""
    _check(a, b)
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul takes f32 or f16 A and B alike and an f32 or f16 "
                        f"output; got {a.dtype}, {b.dtype} -> {out_dtype}")
    if not _on_card("matmul", a, b):
        return matmul_ref(a, b, out_dtype=out_dtype)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype, device=a.device)
    _launch("matmul", a, b, c)
    return c


def matmul_acc(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C += A @ B written into c's storage (no (m, n) temporary), c f32 or
    f16; returns c.  The counterpart of ``matmul_acc_pallas``'s
    ``input_output_aliases``."""
    _check(a, b, c)
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype or c.dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul_acc takes f32 or f16 A and B alike and an f32 or f16 C; "
                        f"got {a.dtype}, {b.dtype}, {c.dtype}")
    if not _on_card("matmul_acc", a, b, c):
        return matmul_acc_ref(a, b, c)
    _launch("matmul_acc", a, b, c)
    return c
