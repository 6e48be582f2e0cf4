"""Paged KV-cache serving subsystem: host-side block-pool allocator.

The device-side pieces live next to their peers: the arena in
``models.transformer.init_paged_cache``, the page-view attention in
``models.layers``, the CUDA decode kernel in ``kernels.paged_attention``,
and the chunked-prefill scheduler in ``launch.scheduler``.
"""
from .kvcache import BlockPool, PoolExhausted

__all__ = ["BlockPool", "PoolExhausted"]
