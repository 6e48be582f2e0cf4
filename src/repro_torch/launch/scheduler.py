"""Continuous-batching decode scheduler over the paged KV cache.

The port of the JAX package's ``launch/scheduler.py`` in its paged mode:

  * A fixed pool of ``slots`` rows backs one fixed-shape decode step; the
    per-slot position vector lets every request advance independently, so
    requests join and leave mid-flight.
  * Requests address K/V through per-request page chains
    (``serving.BlockPool``), so ``prompt + gen`` is bounded by pool
    capacity.  Admission reserves worst-case pages and then runs a chunked
    prefill, one fixed ``(1, chunk)`` slice per prefilling slot per tick,
    interleaved with the decode tick (the admission stall is bounded by one
    chunk).
  * Eviction frees the pages and kills the slot's table row, so a parked
    slot's writes drop and its reads see no page.
  * Arrivals are measured in engine ticks (decode steps), a deterministic
    arrival process; wall-clock time only feeds the reported latency and
    throughput, read after ``torch.cuda.synchronize()`` on the card.

The end-aligned engine (``paged=False``) is not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S
from repro_torch.serving import BlockPool


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float, top_p: float = 1.0) -> torch.Tensor:
    """Temperature / top-p (nucleus) sampling over ``(B, V)`` logits;
    ``temperature == 0`` is greedy argmax (the scheduler's default and the
    test oracle).  Top-p keeps the smallest prefix of the sorted
    distribution whose mass exceeds ``top_p`` (the top token always
    survives), masks the rest to -inf, and samples the renormalized tail
    with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p            # mass before this token < p
        last = (keep.sum(dim=-1) - 1).clamp(min=0)
        thresh = torch.gather(sorted_l, -1, last[..., None])
        logits = torch.where(logits >= thresh, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: Sequence[int]          # token ids; may be empty (generate from BOS)
    gen: int                       # tokens to generate, >= 1
    arrival: int = 0               # engine tick at which the request appears


@dataclass
class Completion:
    rid: int
    tokens: List[int]
    arrival: int
    admitted_tick: int
    done_tick: int
    admitted_s: float              # wall seconds from run start
    first_token_s: float           # wall seconds from run start
    done_s: float

    @property
    def ttft_s(self) -> float:
        """Admission -> first token (prefill latency; queue wait is virtual
        ticks, so pre-admission wall time is not a serving latency)."""
        return self.first_token_s - self.admitted_s


@dataclass
class _Slot:
    req: Request
    tokens: List[int] = field(default_factory=list)
    admitted_tick: int = 0
    admitted_s: float = 0.0
    first_token_s: float = 0.0
    state: str = "decode"          # "prefill" while chunked prefill runs
    cursor: int = 0                # prompt tokens consumed


class Scheduler:
    """Continuous-batching decode engine over the paged block-pool arena.
    The device is the parameters' device."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, bos: int = 0, temperature: float = 0.0,
                 top_p: float = 1.0, seed: int = 0, paged: bool = False,
                 block: int = 16, pool_blocks: Optional[int] = None,
                 chunk: int = 32):
        if not paged:
            raise NotImplementedError(
                "only the paged engine is ported: pass paged=True (the "
                "end-aligned engine is in the ROADMAP's port queue)")
        if cfg.enc_dec:
            raise NotImplementedError("enc-dec serving is not scheduled yet")
        if slots < 1 or max_len < 2:
            raise ValueError(f"need slots >= 1 and max_len >= 2, got "
                             f"{slots}/{max_len}")
        if temperature < 0.0 or not 0.0 < top_p <= 1.0:
            raise ValueError(f"need temperature >= 0 and 0 < top_p <= 1, "
                             f"got {temperature}/{top_p}")
        if not T.supports_paged(cfg):
            raise NotImplementedError(
                f"paged serving needs a pure-attention no-SWA pattern; "
                f"got {cfg.block_pattern} (window={cfg.window})")
        if block < 1 or chunk < 1:
            raise ValueError(f"need block >= 1 and chunk >= 1, got "
                             f"{block}/{chunk}")
        self.cfg, self.params = cfg, params
        self.device = params["embed"]["embedding"].device
        self.slots, self.max_len, self.bos = slots, max_len, bos
        self.temperature, self.top_p, self.seed = temperature, top_p, seed
        self.sampling = temperature > 0.0
        self.block, self.chunk = block, chunk
        self.n_pages = -(-max_len // block)          # block-table width
        self.pool = BlockPool(pool_blocks if pool_blocks is not None
                              else slots * self.n_pages, block)
        self._decode = S.make_decode_step(cfg, return_logits=self.sampling)
        self._chunk_prefill = S.make_chunk_prefill_step(cfg)
        self.reset()

    def reset(self) -> None:
        """Fresh arena, pool and slot state and an empty submission queue;
        the sampling stream restarts from the seed for reproducible runs."""
        self.cache = T.init_paged_cache(self.cfg, self.pool.n_blocks, self.block,
                                        device=self.device)
        self.pool.reset()
        self._tables = np.full((self.slots, self.n_pages), -1, np.int32)
        self._tok = np.zeros((self.slots,), np.int32)
        self._pos = np.zeros((self.slots,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._queue: List[Request] = []

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _first_token(self, logits: torch.Tensor) -> int:
        if self.sampling:
            return int(sample_tokens(logits, self._gen, self.temperature, self.top_p)[0])
        return int(torch.argmax(logits, dim=-1)[0])

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Validate and enqueue one request (``run`` drains the queue).
        Length limits are enforced here, with the limit named: the
        block-table width and the pool capacity."""
        lp = len(req.prompt)
        total = lp + req.gen
        if req.gen < 1 or req.arrival < 0:
            raise ValueError(f"request {req.rid}: need gen >= 1 and "
                             f"arrival >= 0, got {req.gen}/{req.arrival}")
        if total > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {lp} + gen {req.gen} = "
                f"{total} tokens exceeds the block-table width cap "
                f"max_len={self.max_len} ({self.n_pages} pages x block "
                f"{self.block})")
        need = self.pool.blocks_needed(total)
        if need > self.pool.n_blocks:
            raise ValueError(
                f"request {req.rid}: prompt {lp} + gen {req.gen} = "
                f"{total} tokens needs {need} pages, pool capacity is "
                f"{self.pool.n_blocks} blocks x {self.block} tokens")
        self._queue.append(req)

    # ------------------------------------------------------------------
    def _admit_paged(self, req: Request, slot: int, st: _Slot) -> None:
        """Reserve worst-case pages (so alloc-on-write can never fail
        mid-flight) and start the chunked prefill; pages are written chunk
        by chunk in the tick loop."""
        self.pool.admit(req.rid, len(req.prompt) + req.gen)
        self._tables[slot] = -1
        if len(req.prompt) == 0:
            # no prompt: decode from BOS at position 0; stale arena contents
            # beyond position 0 stay behind the length mask
            st.state = "decode"
            self._tok[slot], self._pos[slot] = self.bos, 0
            return
        st.state, st.cursor = "prefill", 0

    def _prefill_chunk_tick(self, slot: int, st: _Slot) -> Optional[int]:
        """Consume ONE ``chunk``-token slice of ``slot``'s prompt.  Returns
        the first generated token when the prompt completes, else None."""
        prompt = np.asarray(st.req.prompt, np.int32)
        lp = int(prompt.shape[0])
        lo = st.cursor
        ln = min(self.chunk, lp - lo)
        self.pool.ensure(st.req.rid, lo + ln)
        toks = np.zeros((1, self.chunk), np.int32)
        toks[0, :ln] = prompt[lo:lo + ln]
        table = self.pool.table(st.req.rid, self.n_pages)[None]
        logits, self.cache = self._chunk_prefill(
            self.params, self._to_device(toks), self.cache, lo,
            self._to_device(table), ln)
        st.cursor = lo + ln
        if st.cursor < lp:
            return None
        st.state = "decode"
        first = self._first_token(logits)
        self._tok[slot], self._pos[slot] = first, lp
        return first

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request] = (), *,
            on_token: Optional[Callable[[int, int], None]] = None) -> dict:
        """Serve ``requests`` (plus anything already ``submit``ted) to
        completion.  Tokens stream per request through ``on_token(rid,
        token)`` (one host sync per engine tick).  Returns completions, the
        tick and decode-step counts, wall time, throughput and the block
        pool's occupancy/fragmentation report."""
        for req in requests:
            self.submit(req)
        pending = deque(sorted(self._queue, key=lambda r: (r.arrival, r.rid)))
        self._queue = []
        active: Dict[int, _Slot] = {}
        free = list(range(self.slots - 1, -1, -1))
        done: Dict[int, Completion] = {}
        generated = 0
        tick = 0
        decode_steps = 0
        t0 = time.perf_counter()

        def finish(slot: int) -> None:
            st = active.pop(slot)
            free.append(slot)
            # eviction: pages return to the pool; the dead table row makes
            # any parked-slot writes drop on the device
            self.pool.free(st.req.rid)
            self._tables[slot] = -1
            done[st.req.rid] = Completion(
                rid=st.req.rid, tokens=st.tokens, arrival=st.req.arrival,
                admitted_tick=st.admitted_tick, done_tick=tick,
                admitted_s=st.admitted_s, first_token_s=st.first_token_s,
                done_s=time.perf_counter() - t0)

        def emit(slot: int, tok: int) -> None:
            nonlocal generated
            st = active[slot]
            if not st.tokens:
                st.first_token_s = time.perf_counter() - t0
            st.tokens.append(tok)
            generated += 1
            if on_token is not None:
                on_token(st.req.rid, tok)

        while pending or active:
            while pending and free and pending[0].arrival <= tick:
                if not self.pool.can_admit(len(pending[0].prompt) + pending[0].gen):
                    break          # FIFO head waits for pages to free up
                req = pending.popleft()
                slot = free.pop()
                st = _Slot(req=req, admitted_tick=tick,
                           admitted_s=time.perf_counter() - t0)
                active[slot] = st
                self._admit_paged(req, slot, st)
            # chunked prefill: one fixed-shape chunk per prefilling slot per
            # tick, interleaved with the decode tick below
            for slot in list(active):
                st = active[slot]
                if st.state != "prefill":
                    continue
                first = self._prefill_chunk_tick(slot, st)
                if first is not None:
                    emit(slot, first)
                    if len(st.tokens) >= st.req.gen:
                        finish(slot)
            decoding = [s for s, st in active.items() if st.state == "decode"]
            if not decoding:
                if active:
                    tick += 1      # prefill-only tick still advances time
                else:
                    # nothing resident: fast-forward the virtual clock
                    tick = pending[0].arrival if pending else tick + 1
                continue
            # alloc-on-write: this tick's token lands at pos, so each
            # decoding row's chain must cover pos+1 tokens (reserved at
            # admission -- ensure can't fail); refresh the device tables
            for slot in decoding:
                st = active[slot]
                self.pool.ensure(st.req.rid, int(self._pos[slot]) + 1)
                self._tables[slot] = self.pool.table(st.req.rid, self.n_pages)
            out, self.cache = self._decode(
                self.params, self._to_device(self._tok), self.cache,
                self._to_device(self._pos), self._to_device(self._tables))
            if self.sampling:
                out = sample_tokens(out, self._gen, self.temperature, self.top_p)
            nxt = out.cpu().numpy()             # host sync = the stream point
            tick += 1
            decode_steps += 1
            for slot in decoding:
                if slot not in active:
                    continue
                self._pos[slot] += 1
                self._tok[slot] = nxt[slot]
                emit(slot, int(nxt[slot]))
                if len(active[slot].tokens) >= active[slot].req.gen:
                    finish(slot)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return {
            "completions": done,
            "generated": generated,
            "ticks": tick,
            "decode_steps": decode_steps,
            "wall_s": wall,
            "tok_s": generated / wall if wall > 0 else float("inf"),
            "pool": self.pool.report(),
        }


def make_requests(n: int, prompt_len: int, gen: int, vocab: int, *,
                  stagger: int = 0, seed: int = 1) -> List[Request]:
    """Uniform synthetic request stream: ``n`` requests of ``prompt_len``
    random prompt tokens, ``gen`` outputs, arriving ``stagger`` ticks apart
    (the same stream as the JAX package's for the same arguments)."""
    rng = np.random.RandomState(seed)
    return [Request(rid=i,
                    prompt=rng.randint(0, vocab, (prompt_len,)).astype(np.int32),
                    gen=gen, arrival=i * stagger)
            for i in range(n)]
