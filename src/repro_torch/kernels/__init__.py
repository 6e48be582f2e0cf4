"""Hand-written Hopper kernels of the port, each beside its plain version.

``paged_attention`` -- paged decode attention (``csrc/paged_attention.cu``).
``flash_attention`` -- full-sequence attention of ``forward`` and the fused
prefill (``csrc/flash_attention.cu``).
``matmul`` / ``matmul_acc`` -- tiled f32 block products (``csrc/matmul.cu``).
``minplus`` -- the (min, +) product (``csrc/minplus.cu``).
``grouped_matmul`` -- an MoE layer's grouped expert products, bounded by
group offsets on the device (``csrc/grouped_matmul.cu``).
``ops`` re-exports them under the reference's names.
"""
