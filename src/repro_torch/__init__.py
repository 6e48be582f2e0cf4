"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA H100.

Modules mirror the JAX package's paths; the JAX package is the reference
the port's tests hold it against.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
