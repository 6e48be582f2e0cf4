"""Paged KV-cache block-pool allocator (the serving subsystem's data layout).

The FooPar move applied to serving memory: the monolithic end-aligned cache
row (``prompt + gen <= max_len`` per slot) is replaced by a managed
distributed collection of fixed-size KV *pages*.  A request's logical token
sequence is a chain of pages named by its *block table*, so its length is
bounded by pool capacity, not by any per-slot rectangle — the layout that
makes ``prompt + gen`` longer than an end-aligned slot servable at all.

Split of responsibilities (mirrors the slot engine's host/device split):

  * ``BlockPool`` (here) is pure host-side accounting: the free list, the
    per-request page chains, admission *reservations*, and the occupancy /
    fragmentation report.  It never touches device memory.
  * The device arena -- one ``(n_blocks, block, kv_heads, hd)`` K and V
    pair per attention layer -- is built by
    ``models.transformer.init_paged_cache`` and written in place by the
    decode / chunked-prefill steps.

Allocation protocol (all methods O(pages touched)):

  * ``admit(rid, total_tokens)`` — called once at admission; *reserves*
    ``blocks_needed(total_tokens)`` blocks so mid-flight growth can never
    fail (no preemption logic needed).  Admission control: the scheduler
    admits only while ``can_admit`` holds.
  * ``ensure(rid, tokens)`` — alloc-on-write: grows the request's page chain
    to cover ``tokens`` logical tokens (one call before every decode tick
    and prefill chunk); draws from the free list, never exceeds the
    reservation.
  * ``free(rid)`` — eviction: the whole chain returns to the free list and
    the reservation is released.

This is the port's own copy of the JAX package's ``serving/kvcache.py``
(host-side numpy, no JAX): the allocator is the same, so the two engines
hand out the same pages for the same request stream.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised when an allocation would exceed the pool (a scheduler bug:
    admission reserves worst-case blocks, so ``ensure`` can never hit it)."""


class BlockPool:
    """Fixed pool of ``n_blocks`` KV pages of ``block`` tokens each."""

    def __init__(self, n_blocks: int, block: int):
        if n_blocks < 1 or block < 1:
            raise ValueError(f"need n_blocks >= 1 and block >= 1, got "
                             f"{n_blocks}/{block}")
        self.n_blocks, self.block = n_blocks, block
        self.reset()

    def reset(self) -> None:
        # pop() from the tail -> blocks hand out in ascending order (stable
        # layouts for tests; not a correctness requirement)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._pages: Dict[int, List[int]] = {}      # rid -> page chain
        self._tokens: Dict[int, int] = {}           # rid -> logical length
        self._reserved: Dict[int, int] = {}         # rid -> reserved blocks
        self.peak_live = 0
        self.frag_at_peak = 0.0

    # -- capacity arithmetic -------------------------------------------------
    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def reserved_blocks(self) -> int:
        return sum(self._reserved.values())

    def can_admit(self, total_tokens: int) -> bool:
        """True iff a request of ``total_tokens`` can be admitted *now*:
        its worst-case block count fits next to the existing reservations
        (reservation-based admission — ``ensure`` can then never fail)."""
        return (self.blocks_needed(total_tokens)
                <= self.n_blocks - self.reserved_blocks)

    # -- lifecycle -----------------------------------------------------------
    def admit(self, rid: int, total_tokens: int) -> None:
        if rid in self._reserved:
            raise ValueError(f"request {rid} is already admitted")
        need = self.blocks_needed(total_tokens)
        if need > self.n_blocks - self.reserved_blocks:
            raise PoolExhausted(
                f"request {rid} needs {need} blocks but only "
                f"{self.n_blocks - self.reserved_blocks} of {self.n_blocks} "
                f"are unreserved")
        self._reserved[rid] = need
        self._pages[rid] = []
        self._tokens[rid] = 0

    def ensure(self, rid: int, tokens: int) -> List[int]:
        """Grow ``rid``'s chain to cover ``tokens`` logical tokens
        (alloc-on-write); returns the (possibly grown) page chain."""
        need = self.blocks_needed(tokens)
        chain = self._pages[rid]
        if need > self._reserved[rid]:
            raise PoolExhausted(
                f"request {rid}: {tokens} tokens need {need} blocks, "
                f"reservation is {self._reserved[rid]}")
        while len(chain) < need:
            chain.append(self._free.pop())
        self._tokens[rid] = max(self._tokens[rid], tokens)
        live = self.live_blocks
        if live >= self.peak_live:
            # snapshot internal fragmentation at the high-water mark (the
            # end-of-run report would otherwise read an empty pool)
            self.peak_live = live
            used = sum(self._tokens.values())
            self.frag_at_peak = 1.0 - used / (live * self.block) if live else 0.0
        return chain

    def free(self, rid: int) -> None:
        """Eviction: the chain returns to the free list (reverse order keeps
        the hand-out ascending), the reservation is released."""
        self._free.extend(reversed(self._pages.pop(rid)))
        del self._tokens[rid]
        del self._reserved[rid]

    def table(self, rid: int, width: int) -> np.ndarray:
        """The request's block table as a fixed-width int32 row: the page
        chain left-aligned, unallocated tail entries -1 (the device steps
        drop writes / mask reads through negative entries)."""
        chain = self._pages[rid]
        if len(chain) > width:
            raise ValueError(f"request {rid}: chain {len(chain)} exceeds "
                             f"table width {width}")
        row = np.full((width,), -1, np.int32)
        row[:len(chain)] = chain
        return row

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        """Occupancy + fragmentation snapshot (serve.py's end-of-run report).

        ``internal_frag`` is the classic paged-memory loss: the fraction of
        *allocated* token slots no live token occupies (last-page slack).
        There is no external fragmentation by construction — any free block
        can serve any request — so the pool also reports ``reserved`` slack
        (blocks promised to admitted requests but not yet written), which is
        what actually gates admission."""
        used_tokens = sum(self._tokens.values())
        live = self.live_blocks
        return {
            "n_blocks": self.n_blocks,
            "block": self.block,
            "free_blocks": self.free_blocks,
            "live_blocks": live,
            "reserved_blocks": self.reserved_blocks,
            "live_requests": len(self._pages),
            "occupancy": live / self.n_blocks,
            "peak_occupancy": self.peak_live / self.n_blocks,
            "internal_frag": (1.0 - used_tokens / (live * self.block)
                              if live else 0.0),
            "frag_at_peak": self.frag_at_peak,
        }
