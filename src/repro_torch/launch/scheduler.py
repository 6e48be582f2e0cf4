"""Slot-based continuous-batching decode scheduler (the serving subsystem).

The port of the JAX package's ``launch/scheduler.py``:

  * A fixed pool of ``slots`` rows backs one fixed-shape decode step; the
    per-slot position vector lets every request advance independently, so
    requests join and leave mid-flight.
  * Eviction: after ``gen`` tokens the slot returns to the free list; a
    parked slot keeps riding the batched step, but its writes stay
    invisible to the next occupant (end-aligned: behind the causal mask, or
    dropped past the row; paged: dropped through its freed block table).
  * Arrivals are measured in engine ticks (decode steps), a deterministic
    arrival process; wall-clock time only feeds the reported latency and
    throughput, read after ``torch.cuda.synchronize()`` on the card.

Two engines (``paged=`` selects one):

  | engine             | cache layout            | admission (prefill)      | request length limit        |
  |--------------------|-------------------------|--------------------------|-----------------------------|
  | end-aligned (dflt) | per-slot (max_len) row  | ONE fused cache-writing  | prompt+gen <= max_len per   |
  |                    | (a ring at a layer's    | forward, bucketed padded | slot (<= a model-wide SWA   |
  |                    | window: SWA)            |                          | window)                     |
  | paged              | shared page arena +     | CHUNKED: fixed (1,chunk) | prompt+gen <= pool capacity |
  |                    | per-request block table | slices interleaved with  | (and the block-table width  |
  |                    | (serving/kvcache.py)    | decode ticks             | cap max_len)                |
  | recurrent fallback | state leaves (no        | per-token B=1 loop (pad  | prompt+gen <= max_len       |
  | (mamba2/m/sLSTM)   | position indexing)      | would corrupt the state) |                             |

End-aligned admission stalls every in-flight decode for a whole prompt
forward (through the flash-attention kernel); chunked prefill bounds that
stall to one ``chunk``-token slice per tick.  A pattern with recurrent
kinds (Mamba2, mLSTM, sLSTM) cannot take a right-padded prompt, so its
admission feeds the prompt through decode steps one token at a time and
takes the first token from the last prompt token's logits (sampled when
sampling is on).  Enc-dec models are not scheduled, as in JAX.

Under a mesh ctx (``ctx=``, inside one rank of ``core.mesh.launch``, with
the rank's parameter blocks) every rank runs this same host loop on the
same requests.  The decode step runs on the batch axes that divide the
slots and a B=1 admission on none (``launch.specs.restrict_batch``); the
slot cache is the rank's blocks (``cache_specs``: the end-aligned rows
split over ``model`` on their length where it divides ``max_len``, else
whole on every rank; a prompt whose bucket ``model`` splits runs the
sequence-sharded region, any other attends the whole gathered K/V), an
admission's one-row cache is ``max_len`` long so that its blocks line up
with the slot rows', and the paged arenas are whole on every rank.  The
steps return
the same global logits on every rank and sampling draws from the same
seeded generator, so every rank takes the same tokens; a rank whose tokens
differ from the others' raises (``_agree``), rank 0 does not overrule it.

One CUDA graph an engine (``decode_graphed``): on the card, an end-aligned
engine of one process replays its decode step from a ``torch.cuda.CUDAGraph``
over every slot, so a tick costs the host one launch and not the step's
thousands of operations.  Its first decode step runs eagerly on a side
stream (the tables made once a shape are made there, outside the graph's
pool), the second is captured and replayed, every later one replayed; a
capture waits for a step while no profile records, so that no span's sync
falls inside it, and a step that cannot be captured raises.  ``_tok`` and
``_pos`` are then numpy views of pinned host tensors, copied without
blocking into the graph's static device inputs before each replay; the
host writes them only once the previous step's tokens have reached it.  A
cache leaf that the step returns anew (a recurrent state) is copied back
into the engine's leaf inside the graph.  ``reset`` drops the graph with
the cache it wrote.  The paged engine (its page writes sync), a rank (its
collectives run on the host), the CPU, the recurrent admission's B=1 steps
and the prefill stay eager.  A kernel wrapper's launch counter counts its
calls, so a replay moves none.

Spans (``runtime/trace.py``; recorded only while a ``torch.profiler``
profile records): ``engine.tick`` an iteration of ``run``'s loop (rows
decoding, admits, chunks); ``engine.admit`` a non-empty end-aligned or
recurrent admission up to its first token on the host and its row insert,
``engine.chunk`` a paged prefill chunk (``tokens`` each); ``step.prefill``
the prefill or chunk step's call; ``step.decode`` the decode step from its
inputs' copy to its tokens on the host (rows; ``graph`` 1 where it is a
replay of the engine's graph, 0 where the step runs eagerly); ``sync`` each
wait for the device (``site``: ``h2d``, ``first_token``, ``decode``,
``agree``, ``run_end``; ``models/`` adds ``paged_write`` and the MoE's).
The MoE layer adds ``moe.ffn`` (rows: tokens) and, inside it,
``moe.experts`` around the grouped products (experts given a row, rows:
assignments); a replay records neither.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dseq import all_gather_dim
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S
from repro_torch.runtime import trace
from repro_torch.serving import BlockPool
from repro_torch.tree import leaves, tree_map


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


def decode_graphed(device: torch.device, paged: bool, ctx) -> bool:
    """Whether an engine replays its decode step from one CUDA graph: on
    the card, over end-aligned rows, in one process."""
    return device.type == "cuda" and not paged and ctx is None


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
    """Continuous-batching decode engine over a fixed slot pool: end-aligned
    cache rows, or the paged block-pool arena with ``paged=True``.  The
    device is the parameters' device."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, bucket: int = 16, bos: int = 0,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 paged: bool = False, block: int = 16,
                 pool_blocks: Optional[int] = None, chunk: int = 32, ctx=None):
        if cfg.enc_dec:
            raise NotImplementedError("enc-dec serving is not scheduled yet")
        if slots < 1 or max_len < 2:
            raise ValueError(f"need slots >= 1 and max_len >= 2, got "
                             f"{slots}/{max_len}")
        if temperature < 0.0 or not 0.0 < top_p <= 1.0:
            raise ValueError(f"need temperature >= 0 and 0 < top_p <= 1, "
                             f"got {temperature}/{top_p}")
        # a model-wide window makes every layer's row a ring of it; with
        # per-layer windows (layer_windows) the full layers hold max_len
        if not paged and cfg.window is not None and max_len > cfg.window:
            raise NotImplementedError(
                f"slots are end-aligned: max_len {max_len} must fit the "
                f"attention window {cfg.window}")
        self.cfg, self.params, self.ctx = cfg, params, ctx
        self.device = params["embed"]["embedding"].device
        # the decode step's ctx (batch axes dividing the slots) and a B=1
        # admission's (batch replicated)
        self._dctx = self._pctx = None
        if ctx is not None:
            from repro_torch.launch.specs import restrict_batch
            self._dctx, self._pctx = restrict_batch(ctx, slots), restrict_batch(ctx, 1)
        self.slots, self.max_len = slots, max_len
        self.bucket, self.bos = max(1, bucket), bos
        self.temperature, self.top_p, self.seed = temperature, top_p, seed
        self.sampling = temperature > 0.0
        self.paged = paged
        self.fused = T.supports_fused_prefill(cfg)
        if paged:
            if not T.supports_paged(cfg):
                raise NotImplementedError(
                    f"paged serving needs a pure-attention no-SWA pattern; "
                    f"got {cfg.block_pattern} (window={cfg.window}, "
                    f"layer_windows={cfg.layer_windows})")
            if block < 1 or chunk < 1:
                raise ValueError(f"need block >= 1 and chunk >= 1, got "
                                 f"{block}/{chunk}")
            self.block, self.chunk = block, chunk
            self.n_pages = -(-max_len // block)          # block-table width
            self.pool = BlockPool(pool_blocks if pool_blocks is not None
                                  else slots * self.n_pages, block)
            self._chunk_prefill = S.make_chunk_prefill_step(cfg, self._pctx)
        elif self.fused:
            self._prefill = S.make_prefill_step(cfg, self._pctx)
        else:
            # the per-token prefill fallback reads each step's logits
            self._step_logits = S.make_decode_step(cfg, return_logits=True, ctx=self._pctx)
        self._decode = S.make_decode_step(cfg, return_logits=self.sampling, paged=paged,
                                          ctx=self._dctx)
        self._graphed = decode_graphed(self.device, paged, ctx)
        self.reset()

    def reset(self) -> None:
        """Fresh cache (and pool) and slot state and an empty submission
        queue; the sampling stream restarts from the seed for reproducible
        runs.  The decode graph goes with the cache it wrote; the next
        decode step warms up anew."""
        self._graph = self._graph_out = None
        self._warm = False
        if self.paged:
            self.cache = T.init_paged_cache(self.cfg, self.pool.n_blocks, self.block,
                                            device=self.device)
            self.pool.reset()
            self._tables = np.full((self.slots, self.n_pages), -1, np.int32)
        else:
            self.cache = T.init_cache(self.cfg, self.slots, self.max_len,
                                      device=self.device, ctx=self._dctx)
        if self._graphed:
            # the graph's inputs: pinned host tensors (``_tok``/``_pos`` are
            # their numpy views) and the static device buffers they go to
            pinned = [torch.zeros((self.slots,), dtype=torch.int32, pin_memory=True)
                      for _ in range(2)]
            self._tok, self._pos = (t.numpy() for t in pinned)
            self._host_in = pinned
            self._dev_in = [torch.zeros_like(t, device=self.device) for t in pinned]
        else:
            self._tok = np.zeros((self.slots,), np.int32)
            self._pos = np.zeros((self.slots,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._queue: List[Request] = []

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # a copy from pageable host memory waits for the stream to drain
        with trace.span("sync", site="h2d"):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode_once(self):
        """One decode step over every slot: (its tokens, or its logits when
        sampling, on the device; whether the engine's graph served it)."""
        if not self._graphed:
            args = (self._to_device(self._tok), self.cache, self._to_device(self._pos))
            if self.paged:
                args += (self._to_device(self._tables),)
            out, self.cache = self._decode(self.params, *args)
            return out, False
        for dev, host in zip(self._dev_in, self._host_in):
            dev.copy_(host, non_blocking=True)
        if self._graph is None:
            if not self._warm or trace.recording_now():
                return self._warm_up(), False
            self._capture()
        self._graph.replay()
        return self._graph_out, True

    def _graph_step(self, adopt: bool) -> torch.Tensor:
        """The decode step on the graph's inputs.  The step gets the cache's
        containers anew (it replaces entries in them).  With ``adopt`` (an
        eager warm-up) the engine takes the leaves the step returns, so a
        state it returns anew is held in the step's own dtype; else such a
        leaf is copied into the engine's, whose addresses the graph reads
        and writes."""
        tok, pos = self._dev_in
        out, cache = self._decode(self.params, tok, tree_map(lambda t: t, self.cache), pos)
        if adopt:
            self.cache = cache
            return out
        for mine, new in zip(leaves(self.cache), leaves(cache)):
            if new is not mine:
                if (new.dtype, new.shape) != (mine.dtype, mine.shape):
                    raise RuntimeError(f"the step returned a cache leaf of {new.dtype} "
                                       f"{tuple(new.shape)} for one of {mine.dtype} "
                                       f"{tuple(mine.shape)}")
                mine.copy_(new)
        return out

    def _warm_up(self) -> torch.Tensor:
        """The step run eagerly on a side stream, as before a capture."""
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = self._graph_step(adopt=True)
        here.wait_stream(side)
        self._warm = True
        return out

    def _capture(self) -> None:
        """Record the step in the engine's graph; nothing runs until the
        replay that follows."""
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self._graph_step(adopt=False)
        except RuntimeError as e:
            raise RuntimeError(f"the end-aligned decode step of {self.cfg.name} could not be "
                               f"captured in a CUDA graph: {e}") from e
        self._graph, self._graph_out = graph, out

    def _first_token(self, logits: torch.Tensor) -> int:
        if self.sampling:
            tok = sample_tokens(logits, self._gen, self.temperature, self.top_p)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = self._agree(tok)
        with trace.span("sync", site="first_token"):
            return int(tok[0])

    def _agree(self, tokens: torch.Tensor) -> torch.Tensor:
        """Under a ctx: the ranks' tokens side by side (one all-gather over
        the mesh); a rank whose tokens differ from rank 0's raises, on every
        rank.  ``tokens`` otherwise."""
        if self.ctx is None:
            return tokens
        mesh = self.ctx.mesh
        with trace.span("sync", site="agree"):
            got = all_gather_dim(tokens[None], mesh.axis_names, 0, mesh)
            bad = [r for r in range(got.shape[0]) if not torch.equal(got[r], got[0])]
        if bad:
            raise RuntimeError(f"ranks {bad} took other tokens than rank 0: "
                               f"{got[bad].tolist()} against {got[0].tolist()}")
        return tokens

    def _insert(self, row, slot: int) -> None:
        """Copy a one-row cache into ``slot``'s row of the slot cache, in
        place, from position 0 (JAX's ``_insert_impl``), cast to the slot
        cache's dtype: K/V positions past the row keep the previous
        occupant's, behind the causal mask; a recurrent state is replaced
        whole.  Under a ctx the row (batch-replicated, ``max_len`` long:
        ``_row``) holds the same blocks as the slot rows, and the ranks
        whose batch block holds ``slot`` copy theirs."""
        local = slot
        if self._dctx is not None and self._dctx.batch_axes:
            rows = self.cache_rows()
            local -= self._dctx.mesh.index(self._dctx.batch_axes) * rows
            if not 0 <= local < rows:
                return
        for big, small in zip(self.cache, row):
            for b, s in zip(leaves(big), leaves(small)):
                b[local, :s.shape[1]].copy_(s[0])

    def _row(self, length: int):
        """A fresh one-row cache for an admission of ``length`` positions;
        under a ctx ``max_len`` long, so that its blocks over ``model`` line
        up with the slot rows'."""
        n = self.max_len if self.ctx is not None else length
        return T.init_cache(self.cfg, 1, n, device=self.device, ctx=self._pctx)

    def cache_rows(self) -> int:
        """The slot cache's rows on this rank."""
        if self._dctx is None or not self._dctx.batch_axes:
            return self.slots
        return self.slots // self._dctx.mesh.size(self._dctx.batch_axes)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Validate and enqueue one request (``run`` drains the queue).
        Length limits are enforced here, with the limit named: end-aligned
        mode is bounded by the per-slot row, paged mode by the block-table
        width and the pool capacity."""
        lp = len(req.prompt)
        total = lp + req.gen
        if req.gen < 1 or req.arrival < 0:
            raise ValueError(f"request {req.rid}: need gen >= 1 and "
                             f"arrival >= 0, got {req.gen}/{req.arrival}")
        if self.paged:
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
        elif total > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {lp} + gen {req.gen} = {total} "
                f"tokens exceeds the end-aligned slot capacity "
                f"max_len={self.max_len}")
        self._queue.append(req)

    # ------------------------------------------------------------------
    def _bucketed(self, n: int) -> int:
        return min(self.max_len, -(-n // self.bucket) * self.bucket)

    def _admit(self, req: Request, slot: int) -> Optional[int]:
        """End-aligned admission: one fused prefill of ``req``'s prompt,
        right-padded to its bucket, into a fresh (1, bucket) row, copied into
        ``slot``.  Returns the first token (None for an empty prompt: the
        first token then comes from the next decode step, fed from BOS).
        Leaves ``_tok``/``_pos`` pointing at the next decode input."""
        prompt = np.asarray(req.prompt, np.int32)
        lp = int(prompt.shape[0])
        if lp == 0:
            # no prompt: generation starts from BOS at position 0 on a fresh
            # row -- recurrent state has no position indexing, so the
            # previous occupant's must be zeroed (a prompt's row replaces it)
            self._insert(self._row(self._bucketed(1)), slot)
            self._tok[slot], self._pos[slot] = self.bos, 0
            return None
        with trace.span("engine.admit", tokens=lp):
            if not self.fused:
                return self._admit_recurrent(prompt, slot)
            lb = self._bucketed(lp)
            toks = np.zeros((1, lb), np.int32)
            toks[0, :lp] = prompt
            batch = {"tokens": self._to_device(toks),
                     "length": self._to_device(np.array([lp], np.int32))}
            with trace.span("step.prefill"):
                logits, row = self._prefill(self.params, batch, self._row(lb))
            first = self._first_token(logits)
            self._insert(row, slot)
            self._tok[slot], self._pos[slot] = first, lp
            return first

    def _admit_recurrent(self, prompt: np.ndarray, slot: int) -> int:
        """Recurrent admission: the prompt through unpadded B=1 decode steps
        (padding would enter the state); the last step's logits give the
        first token."""
        lp = int(prompt.shape[0])
        row = self._row(self._bucketed(lp))
        with trace.span("step.prefill"):
            for i in range(lp):
                logits, row = self._step_logits(
                    self.params, self._to_device(prompt[i:i + 1]), row, i)
        first = self._first_token(logits)
        self._insert(row, slot)
        self._tok[slot], self._pos[slot] = first, lp
        return first

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
        with trace.span("engine.chunk", tokens=ln):
            self.pool.ensure(st.req.rid, lo + ln)
            toks = np.zeros((1, self.chunk), np.int32)
            toks[0, :ln] = prompt[lo:lo + ln]
            table = self.pool.table(st.req.rid, self.n_pages)[None]
            args = (self._to_device(toks), self.cache, lo, self._to_device(table), ln)
            with trace.span("step.prefill"):
                logits, self.cache = self._chunk_prefill(self.params, *args)
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
        tick, decode-step and prefill (non-empty end-aligned admission)
        counts, the decode steps the engine's graph served
        (``decode_replays``), wall time, throughput and, in paged mode, the
        block pool's occupancy/fragmentation report."""
        for req in requests:
            self.submit(req)
        pending = deque(sorted(self._queue, key=lambda r: (r.arrival, r.rid)))
        self._queue = []
        active: Dict[int, _Slot] = {}
        free = list(range(self.slots - 1, -1, -1))
        done: Dict[int, Completion] = {}
        generated = 0
        tick = 0
        decode_steps = decode_replays = prefills = 0
        t0 = time.perf_counter()

        def finish(slot: int) -> None:
            st = active.pop(slot)
            free.append(slot)
            if self.paged:
                # eviction: pages return to the pool; the dead table row
                # makes any parked-slot writes drop on the device
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
            with trace.span("engine.tick") as span:
                admits = chunks = 0
                while pending and free and pending[0].arrival <= tick:
                    if self.paged and not self.pool.can_admit(
                            len(pending[0].prompt) + pending[0].gen):
                        break          # FIFO head waits for pages to free up
                    req = pending.popleft()
                    slot = free.pop()
                    st = _Slot(req=req, admitted_tick=tick,
                               admitted_s=time.perf_counter() - t0)
                    active[slot] = st
                    admits += 1
                    if self.paged:
                        self._admit_paged(req, slot, st)
                    else:
                        first = self._admit(req, slot)
                        if first is not None:
                            prefills += 1
                            emit(slot, first)
                            if len(st.tokens) >= req.gen:
                                finish(slot)
                if self.paged:
                    # chunked prefill: one fixed-shape chunk per prefilling
                    # slot per tick, interleaved with the decode tick below
                    for slot in list(active):
                        st = active[slot]
                        if st.state != "prefill":
                            continue
                        chunks += 1
                        first = self._prefill_chunk_tick(slot, st)
                        if first is not None:
                            emit(slot, first)
                            if len(st.tokens) >= st.req.gen:
                                finish(slot)
                decoding = [s for s, st in active.items() if st.state == "decode"]
                span.set(rows=len(decoding), admits=admits, chunks=chunks)
                if not decoding:
                    if active:
                        tick += 1      # prefill-only tick still advances time
                    else:
                        # nothing resident: fast-forward the virtual clock
                        tick = pending[0].arrival if pending else tick + 1
                    continue
                if self.paged:
                    # alloc-on-write: this tick's token lands at pos, so each
                    # decoding row's chain must cover pos+1 tokens (reserved
                    # at admission -- ensure can't fail); refresh the tables
                    for slot in decoding:
                        st = active[slot]
                        self.pool.ensure(st.req.rid, int(self._pos[slot]) + 1)
                        self._tables[slot] = self.pool.table(st.req.rid, self.n_pages)
                with trace.span("step.decode", rows=len(decoding)) as sp:
                    out, replayed = self._decode_once()
                    sp.set(graph=int(replayed))
                    if self.sampling:
                        out = sample_tokens(out, self._gen, self.temperature, self.top_p)
                    out = self._agree(out)
                    with trace.span("sync", site="decode"):
                        nxt = out.cpu().numpy()   # host sync = the stream point
                tick += 1
                decode_steps += 1
                decode_replays += replayed
                for slot in decoding:
                    if slot not in active:
                        continue
                    self._pos[slot] += 1
                    self._tok[slot] = nxt[slot]
                    emit(slot, int(nxt[slot]))
                    if len(active[slot].tokens) >= active[slot].req.gen:
                        finish(slot)
        if self.device.type == "cuda":
            with trace.span("sync", site="run_end"):
                torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        out = {
            "completions": done,
            "generated": generated,
            "ticks": tick,
            "decode_steps": decode_steps,
            "decode_replays": decode_replays,
            "prefills": prefills,
            "wall_s": wall,
            "tok_s": generated / wall if wall > 0 else float("inf"),
        }
        if self.paged:
            out["pool"] = self.pool.report()
        return out


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
