"""The (min, +) matrix product: the CUDA kernel's wrapper and its plain version.

``minplus(a, b)`` is the local product of blocked Floyd-Warshall
(``core/floyd_warshall.py::blocked_floyd_warshall(minplus=)``).  For tensors
on the card it launches the hand-written Hopper kernel in ``csrc/minplus.cu``
or raises; for tensors on the CPU it runs ``minplus_ref``.  Nothing else
selects the path, and no failure falls back to the plain version.

Both versions propagate NaN through the minimum, as ``jnp.min`` /
``jnp.minimum`` in the reference do (the kernel uses PTX ``min.NaN``, not
``fminf``, which would drop a NaN).  Floyd-Warshall inputs hold +inf for
absent edges and never NaN.  Each output element is one rounded add per
(i, k, j) and exact minima, so the kernel and the plain version agree
exactly.
"""
from __future__ import annotations

import torch

from .matmul import _check, _on_card, launch_tile

launches = 0          # kernel launches; chip_smoke.py resets and reads it
# elements of the (m, chunk, n) intermediate of the plain version (256 MiB)
_REF_CHUNK_ELEMS = 1 << 26


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = min_k A[i, k] + B[k, j], chunked over k with a running
    minimum (the one-shot ``a[:, :, None] + b[None]`` of ``ref.minplus``
    would need m*k*n elements at once)."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((m, n), float("inf"), dtype=torch.float32, device=a.device)
    kc = max(1, min(k, _REF_CHUNK_ELEMS // max(1, m * n)))
    af, bf = a.float(), b.float()
    for k0 in range(0, k, kc):
        part = (af[:, k0:k0 + kc, None] + bf[None, k0:k0 + kc, :]).amin(dim=1)
        out = torch.minimum(out, part)
    return out.to(a.dtype)


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The (min, +) product in A's dtype (f32): the CUDA kernel for tensors
    on the card, the plain version on the CPU."""
    global launches
    _check(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"minplus takes f32 A and B; got {a.dtype}, {b.dtype}")
    if not _on_card("minplus", a, b):
        return minplus_ref(a, b)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    launch_tile("minplus", "repro_minplus", "minplus", (), a, b, c)
    launches += 1
    return c
