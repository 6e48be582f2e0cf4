"""Tiled matrix products: the CUDA kernels' wrappers and their plain versions.

``matmul(a, b)`` and ``matmul_acc(a, b, c)`` are the local block products of
the distributed matmul path (``core/dns_matmul.py``, ``core/summa.py``,
``core/summa_pipelined.py``).  For tensors on the card they launch a
hand-written Hopper kernel of ``csrc/matmul.cu`` or raise; for tensors on
the CPU they run ``matmul_ref`` / ``matmul_acc_ref``.  Nothing else selects
the path, and no failure falls back to another kernel or to the plain
version.

Which kernel, by the input dtype alone (``_route``, ``_route_acc``):
  f16 ``matmul``      -> "wgmma": the tensor-core kernel (TMA-fed wgmma
                         tiles, f32 accumulator);
  f32 ``matmul``      -> "simt": IEEE f32 on the CUDA cores (no TF32);
  f32 ``matmul_acc``  -> "tma": IEEE f32 on the CUDA cores, fed by TMA
                         (``csrc/ffma_tile.cuh``);
  f16 ``matmul_acc``  -> "simt": the CUDA-core tile of f32 ``matmul``.
The TMA-fed routes read A and B only where TMA can
(``check_tma_alignment``), else the wrapper raises; no route takes another's
inputs.  ``launches`` counts each kernel apart: "matmul" (SIMT),
"matmul_f16_wgmma", "matmul_acc" (f32, TMA) and "matmul_acc_f16_simt".

All accumulate in f32, as the Pallas kernels do with
``preferred_element_type=f32``; products of f16 values are exact in f32.
The plain versions rely on PyTorch's default of
``torch.backends.cuda.matmul.allow_tf32 = False`` for tensors on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1}

# kernel launches by kernel; chip_smoke.py resets and reads them
launches = {"matmul": 0, "matmul_f16_wgmma": 0, "matmul_acc": 0, "matmul_acc_f16_simt": 0}
# None, or a list that each tile-kernel launch (matmul, matmul_acc, minplus)
# appends its (name, start, end) CUDA events to; chip_smoke.py sums their
# device time over a run
events = None


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation (``kernels/ref.py::matmul``)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_acc_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C += A @ B in c's storage; returns c."""
    return c.addmm_(a.float(), b.float())


def _route(dtype: torch.dtype) -> str:
    """The kernel that ``matmul`` launches for inputs of ``dtype``: "wgmma"
    (tensor cores) for f16, "simt" (CUDA cores, IEEE f32) for f32."""
    return "wgmma" if dtype == torch.float16 else "simt"


def _route_acc(dtype: torch.dtype) -> str:
    """The kernel that ``matmul_acc`` launches for inputs of ``dtype``:
    "tma" (the TMA-fed CUDA-core tile, IEEE f32) for f32, "simt" (the
    register-staged CUDA-core tile) for f16."""
    return "tma" if dtype == torch.float32 else "simt"


def check_tma_alignment(name: str, shape, strides, address: int, element_size: int) -> None:
    """Raise unless a row-major matrix (``shape``, element ``strides``, base
    ``address``) can be read by TMA: a 16-byte aligned base and a row stride
    of a multiple of 16 bytes (a matrix of one row has no row stride to
    speak of)."""
    rows = shape[0]
    row_bytes = strides[0] * element_size
    if address % 16 or (rows > 1 and row_bytes % 16):
        raise ValueError(
            f"the {name} kernel reads its inputs with TMA, which needs a "
            f"16-byte aligned base and a row stride of a multiple of 16 bytes; got a "
            f"{tuple(shape)} view at address {address:#x} with row stride {row_bytes} B "
            f"(a copy with .contiguous() on a width of a multiple of {16 // element_size} "
            f"elements meets it)")


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
    if _route(a.dtype) == "wgmma":
        for t in (a, b):
            check_tma_alignment("matmul", t.shape, t.stride(), t.data_ptr(), t.element_size())
        launch_tile("matmul", "repro_matmul_f16", "matmul_f16_wgmma",
                    (_DTYPE_CODE[out_dtype],), a, b, c)
        launches["matmul_f16_wgmma"] += 1
    else:
        launch_tile("matmul", "repro_matmul", "matmul",
                    (_DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype]), a, b, c)
        launches["matmul"] += 1
    return c


def matmul_acc(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C += A @ B written into c's storage (no (m, n) temporary); returns c.
    The counterpart of ``matmul_acc_pallas``'s ``input_output_aliases``."""
    _check(a, b, c)
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype or c.dtype != torch.float32:
        raise TypeError(f"matmul_acc takes f32 or f16 A and B alike and an f32 C; got "
                        f"{a.dtype}, {b.dtype}, {c.dtype}")
    if not _on_card("matmul_acc", a, b, c):
        return matmul_acc_ref(a, b, c)
    if _route_acc(a.dtype) == "tma":
        for t in (a, b):
            check_tma_alignment("matmul_acc", t.shape, t.stride(), t.data_ptr(),
                                t.element_size())
        name = "matmul_acc"
    else:
        name = "matmul_acc_f16_simt"
    launch_tile("matmul", "repro_matmul_acc", name, (_DTYPE_CODE[a.dtype],), a, b, c)
    launches[name] += 1
    return c
