"""The port's kernel entry points under the reference's names
(``repro/kernels/ops.py``): each runs its CUDA kernel for tensors on the card
and its plain version for tensors on the CPU."""
from .flash_attention import flash_attention  # noqa: F401
from .matmul import matmul, matmul_acc  # noqa: F401
from .minplus import minplus  # noqa: F401
from .paged_attention import paged_attention  # noqa: F401
