"""What the harness sees of a run: one timestamp per streamed token, and
the arithmetic that turns those records into the cell's numbers.

The load is a closed loop of ``clients`` = ``slots`` users.  Every
request is submitted before the run starts and the scheduler admits them
first come, first served as slots free up, so request ``n`` counts as sent
at the loop's start when ``n < slots`` and otherwise at the last token of
the ``(n - slots)``-th request to finish.  The window opens at the last
token of the ``warm``-th request to finish and lasts ``seconds``; the
recorder ends the run from inside the token callback at the first token at
or past its close.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

# on_token calls closer than this belong to one emission burst: a decode
# tick streams all its tokens in one host loop, while two bursts are always
# separated by a forward on the device
BURST_GAP_S = 1e-3


class WindowClosed(Exception):
    """Raised from the token callback to end the run at the window's close."""


class Recorder:
    """The ``on_token`` callback: it stamps each token with the host clock
    and opens and closes the window."""

    def __init__(self, gens: List[int], warm: int, seconds: float,
                 on_open: Optional[Callable[[], None]] = None,
                 on_close: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.gens, self.warm, self.seconds = gens, warm, seconds
        self.on_open, self.on_close, self.clock = on_open, on_close, clock
        self.t: List[float] = []
        self.rid: List[int] = []
        self.tokens: List[List[int]] = [[] for _ in gens]
        self.done: List[int] = []          # rids in the order they finished
        self.done_t: List[float] = []
        self.start = clock()
        self.open: Optional[float] = None
        self.close: Optional[float] = None

    def on_token(self, rid: int, tok: int) -> None:
        t = self.clock()
        if self.close is not None and t >= self.close:
            if self.on_close is not None:
                self.on_close()
            raise WindowClosed
        self.t.append(t)
        self.rid.append(rid)
        toks = self.tokens[rid]
        toks.append(int(tok))
        if len(toks) == self.gens[rid]:
            self.done.append(rid)
            self.done_t.append(t)
            if self.open is None and len(self.done) == self.warm:
                self.open, self.close = t, t + self.seconds
                if self.on_open is not None:
                    self.on_open()


class Run:
    """A finished recording, read inside the window ``[open, close)``."""

    def __init__(self, rec: Recorder, prompt_lens: List[int], slots: int,
                 chunk: Optional[int] = None):
        if rec.open is None:
            raise ValueError("the window never opened")
        self.open, self.close = rec.open, rec.close
        self.window_s = rec.close - rec.open
        self.gens = np.asarray(rec.gens, np.int64)
        self.prompt_lens = np.asarray(prompt_lens, np.int64)
        self.tokens = rec.tokens
        self.t = np.asarray(rec.t, np.float64)
        self.rid = np.asarray(rec.rid, np.int64)
        n = len(rec.gens)
        # index of each token within its request
        self.idx = np.zeros(len(self.t), np.int64)
        seen = np.zeros(n, np.int64)
        for i, r in enumerate(rec.rid):
            self.idx[i] = seen[r]
            seen[r] += 1
        self.first = np.full(n, np.inf)
        firsts = self.idx == 0
        self.first[self.rid[firsts]] = self.t[firsts]
        self.done_t = np.full(n, np.inf)
        self.done_t[np.asarray(rec.done, np.int64)] = rec.done_t
        self.sent = np.full(n, np.inf)
        self.sent[:min(slots, n)] = rec.start
        k = min(n - slots, len(rec.done_t))
        if k > 0:
            self.sent[slots:slots + k] = rec.done_t[:k]
        self.slots, self.chunk = slots, chunk

    def inside(self, t):
        return (t >= self.open) & (t < self.close)

    # ---- end to end ----------------------------------------------------
    def out_tokens(self) -> int:
        return int(self.inside(self.t).sum())

    def attempted(self) -> np.ndarray:
        """The rids sent inside the window."""
        return np.nonzero(self.inside(self.sent))[0]

    def ttft_s(self) -> np.ndarray:
        """Send -> first token of every request sent inside the window; one
        with no first token by the close counts at close - send."""
        r = self.attempted()
        return np.minimum(self.first[r], self.close) - self.sent[r]

    def itl_s(self) -> np.ndarray:
        """Every gap between consecutive tokens of one request, both inside
        the window."""
        keep = self.inside(self.t)
        order = np.lexsort((self.t, self.rid))
        t, rid, k = self.t[order], self.rid[order], keep[order]
        same = (rid[1:] == rid[:-1]) & k[1:] & k[:-1]
        return (t[1:] - t[:-1])[same]

    def kv_live_tokens(self) -> float:
        """The tokens that the requests in flight hold in the cache, averaged
        over the window: from each token of a request to its next (to the
        close for one still in flight), its prompt and the tokens so far."""
        order = np.lexsort((self.t, self.rid))
        t, rid, idx = self.t[order], self.rid[order], self.idx[order]
        last = idx == self.gens[rid] - 1
        nxt = np.where(last, t, self.close)
        same = rid[1:] == rid[:-1]
        nxt[:-1][same] = t[1:][same]
        dur = np.clip(np.minimum(nxt, self.close) - np.maximum(t, self.open), 0, None)
        return float(((self.prompt_lens[rid] + idx + 1) * dur).sum() / self.window_s)

    def finished(self) -> np.ndarray:
        """The rids whose last token came inside the window."""
        return np.nonzero(self.inside(self.done_t))[0]

    # ---- ticks ---------------------------------------------------------
    def decode_bursts(self) -> np.ndarray:
        """The host time at which each engine tick's decode tokens arrived:
        the first token of every run of non-first tokens whose calls follow
        each other within ``BURST_GAP_S``.  A prefill's first token always
        stands apart (a forward on the device separates it from any
        other call)."""
        dec = self.idx > 0
        gap = np.diff(self.t, prepend=-np.inf)
        prev_dec = np.concatenate([[False], dec[:-1]])
        starts = dec & ~(prev_dec & (gap < BURST_GAP_S))
        return self.t[starts]

    def ticks(self) -> tuple:
        """(wall seconds, carried an admission or a prefill chunk) of every
        tick whose both ends lie in the window.  Tick k runs from burst k-1
        to burst k.  A request sent at t is admitted in the first tick that
        ends after t and takes ``ceil(prompt / chunk)`` ticks of chunks in
        the paged engine (one fused prefill in the end-aligned one)."""
        b = self.decode_bursts()
        prefill = np.zeros(len(b), bool)
        admit = np.searchsorted(b, self.sent[np.isfinite(self.sent)], side="right")
        lens = self.prompt_lens[np.isfinite(self.sent)]
        n_chunks = np.ones_like(lens) if self.chunk is None else -(-lens // self.chunk)
        for a, c in zip(admit, n_chunks):
            prefill[a:a + c] = True
        walls = np.diff(b)
        carried = prefill[1:]
        keep = self.inside(b[:-1]) & self.inside(b[1:])
        return walls[keep], carried[keep]


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile over all samples (numpy's linear rule); None for
    no samples."""
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, q)) if v.size else None
