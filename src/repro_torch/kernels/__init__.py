"""Hand-written Hopper kernels of the port, each beside its plain version.

``paged_attention`` -- paged decode attention (``csrc/paged_attention.cu``).
"""
