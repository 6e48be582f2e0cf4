"""The logits tap: the program's own logits at the tokens the check judges.

The harness builds the scheduler through the tap (``Tap.installed``), which
wraps the step factories of ``repro_torch.parallel.steps`` that the
scheduler calls while it is built:

  * the greedy decode step is built with ``return_logits=True`` and the tap
    takes ``torch.argmax`` of its f32 logits itself, as the step's own
    greedy output does, so the served tokens are the same with and without
    the tap.  Each slot's logit rows (in bf16) and argmax tokens go into a
    ring of ``rows`` on the device, at the row's position modulo ``rows``;
  * the prefill and chunked-prefill steps' last logits are held until the
    request's first token streams.

On the host, ``on_token`` follows the token stream.  At a request's first
token it finds the request's slot: the one whose entries in the
scheduler's ``_pos`` and ``_tok`` are the prompt's length and that token,
among the slots that hold no request in flight (the request is left
unplaced where two match), and copies the held prefill logits to that
slot.  A request whose slot still holds its length and last token when it
finishes is placed.  If it finishes inside the window and the check's
sample may still pick it (the longest finished request, or one of the
``keep - 1`` lowest ranks of the seed's order: ``check.sample``), its
slot's rows are copied into a store of ``keep`` requests before the next
step can write over them.  Nothing the tap does on the device makes the
host wait: every write is a copy or an index with device tensors.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

FACTORIES = ("make_decode_step", "make_prefill_step", "make_chunk_prefill_step")


class Tap:
    """The rings, the store and the stream's bookkeeping of one run."""

    def __init__(self, *, slots: int, rows: int, keep: int, vocab: int, device):
        dev = torch.device(device)
        bf16 = torch.bfloat16
        self.rows, self.keep = rows, keep
        self.ring = torch.zeros(slots, rows, vocab, dtype=bf16, device=dev)
        self.ring_arg = torch.zeros(slots, rows, dtype=torch.int64, device=dev)
        self.first = torch.zeros(slots, vocab, dtype=bf16, device=dev)
        self.first_arg = torch.zeros(slots, dtype=torch.int64, device=dev)
        self.store = torch.zeros(keep, rows, vocab, dtype=bf16, device=dev)
        self.store_arg = torch.zeros(keep, rows, dtype=torch.int64, device=dev)
        self.store_first = torch.zeros(keep, vocab, dtype=bf16, device=dev)
        self.store_first_arg = torch.zeros(keep, dtype=torch.int64, device=dev)
        self._slot_rows = torch.arange(slots, device=dev)
        self._first_held = np.zeros(slots, bool)       # the slot's first row is its request's
        self._store_first_held = np.zeros(keep, bool)
        self._free = list(range(keep))
        self._last: Optional[torch.Tensor] = None      # the latest prefill's last logits
        self.sched = None

    # ---- the steps ------------------------------------------------------
    def wrap_decode(self, make):
        """``make_decode_step`` whose greedy step records its logits."""
        def factory(cfg, *, return_logits: bool = False, **kw):
            step = make(cfg, return_logits=True, **kw)
            if return_logits:
                return step

            def tapped(params, token, cache, pos, *rest):
                logit, cache = step(params, token, cache, pos, *rest)
                tok = torch.argmax(logit, dim=-1)
                cell = pos.long() % self.rows
                self.ring[self._slot_rows, cell] = logit.to(self.ring.dtype)
                self.ring_arg[self._slot_rows, cell] = tok
                return tok.to(torch.int32), cache
            return tapped
        return factory

    def wrap_prefill(self, make):
        """A prefill factory whose step holds its last logits."""
        def factory(cfg, *args, **kw):
            step = make(cfg, *args, **kw)

            def tapped(*a):
                out = step(*a)
                self._last = out[0][-1]
                return out
            return tapped
        return factory

    @contextmanager
    def installed(self):
        """The steps of a scheduler built inside the block go through the
        tap; the factories are restored after it."""
        from repro_torch.parallel import steps
        saved = {name: getattr(steps, name) for name in FACTORIES}
        steps.make_decode_step = self.wrap_decode(saved["make_decode_step"])
        steps.make_prefill_step = self.wrap_prefill(saved["make_prefill_step"])
        steps.make_chunk_prefill_step = self.wrap_prefill(saved["make_chunk_prefill_step"])
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(steps, name, fn)

    # ---- the stream -----------------------------------------------------
    def attach(self, sched, prompt_lens, gens, ranks) -> None:
        """Follow ``sched`` serving requests of these prompt lengths and
        outputs, ``ranks`` being the seed's order of them."""
        self.sched = sched
        self.lens = np.asarray(prompt_lens, np.int64)
        self.gens = np.asarray(gens, np.int64)
        self.total = self.lens + self.gens
        self.ranks = np.asarray(ranks)
        self.placed = np.zeros(len(self.lens), bool)
        self.kept: dict = {}                           # rid -> store index
        self._slot_of: dict = {}

    def _holds(self, length: int, tok: int) -> np.ndarray:
        """Per slot: the scheduler's next input there is ``tok`` at
        position ``length``."""
        return (np.asarray(self.sched._pos) == length) & (np.asarray(self.sched._tok) == tok)

    def on_token(self, rid: int, tok: int, j: int, window_open: bool) -> None:
        """Token ``j`` of request ``rid`` has streamed; ``window_open``: the
        window was open at it."""
        if j == 0:
            hit = self._holds(self.lens[rid], tok)
            hit[list(self._slot_of.values())] = False
            s = int(np.flatnonzero(hit)[0]) if hit.sum() == 1 else None
            if s is not None:
                self._slot_of[rid] = s
                self._first_held[s] = self._last is not None
                if self._last is not None:
                    self.first[s].copy_(self._last)
                    self.first_arg[s].copy_(torch.argmax(self._last))
            self._last = None
        if j < self.gens[rid] - 1:
            return
        s = self._slot_of.pop(rid, None)
        if s is None or not self._holds(self.lens[rid] + j, tok)[s]:
            return
        self.placed[rid] = True
        if window_open:
            self._keep(rid, s)

    def _keep(self, rid: int, s: int) -> None:
        cand = list(self.kept) + [rid]
        want = set(sorted(cand, key=lambda r: self.ranks[r])[:self.keep - 1])
        want.add(max(cand, key=lambda r: (self.total[r], -r)))
        if rid not in want:
            return
        for r in [r for r in self.kept if r not in want]:
            self._free.append(self.kept.pop(r))
        k = self._free.pop()
        self.store[k].copy_(self.ring[s])
        self.store_arg[k].copy_(self.ring_arg[s])
        self.store_first[k].copy_(self.first[s])
        self.store_first_arg[k].copy_(self.first_arg[s])
        self._store_first_held[k] = self._first_held[s]
        self.kept[rid] = k

    def detach(self) -> None:
        """Free the rings and let go of the scheduler once the window has
        closed; the store stays."""
        self.sched = self._last = None
        self.ring = self.ring_arg = self.first = self.first_arg = None

    # ---- after the window -----------------------------------------------
    def rows_for(self, rid: int, n_served: int, n_judged: int):
        """The kept logits of request ``rid``'s last ``n_judged`` of its
        ``n_served`` tokens: (which of them have a row (bool, n_judged),
        their rows (f32), their argmax tokens)."""
        k = self.kept[rid]
        js = np.arange(n_served - n_judged, n_served)
        held = (js > 0) | self._store_first_held[k]
        cells = torch.as_tensor((self.lens[rid] + js[held] - 1) % self.rows,
                                device=self.store.device)
        rows = self.store[k, cells].float()
        arg = self.store_arg[k, cells]
        if held[0] and js[0] == 0:
            rows[0] = self.store_first[k].float()
            arg[0] = self.store_first_arg[k]
        return held, rows, arg
