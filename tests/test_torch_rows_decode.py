"""The end-aligned decode through the paged-attention kernel.

A decode of one token a row over the end-aligned rows (B, L, Hkv, hd) reads
the rows as a page arena under a fixed block table
(``layers._rows_decode``) wherever the kernel takes the shapes, instead of
``_sdpa``'s mask over every whole row.  On the CPU the wrapper runs its plain
version, so these tests hold the route's view, table and lengths against
``_sdpa`` on the same rows, and name the shapes that keep ``_sdpa``.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.scheduler import Request, Scheduler
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# the kernel's own oracle bound (``chip_smoke.KERNEL_TOL``): f32 differs in
# summation order only, bf16 by a rounding of the probabilities
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
HKV, HD = 2, 32


def _cfg(rep: int, dtype: torch.dtype, window=None):
    return configs.reduced(configs.get("llama3.2-3b")).replace(
        n_heads=HKV * rep, n_kv_heads=HKV, head_dim=HD, dtype=str(dtype)[6:],
        window=window)


class _Calls:
    """``layers.paged_attention`` with a count of its calls."""

    def __init__(self, monkeypatch):
        self.n, real = 0, L.paged_attention

        def counted(*args, **kw):
            self.n += 1
            return real(*args, **kw)
        monkeypatch.setattr(L, "paged_attention", counted)


def _decode(cfg, cache_pos, lk, *, cache_dtype=None, grad=False, strided=False, seed=0):
    """One decode token a row through ``attention`` over random rows of
    ``lk`` slots: (output, the rows after the call's write)."""
    g = torch.Generator().manual_seed(seed)
    p = L.attention_init(g, cfg)
    b = len(cache_pos)
    x = torch.randn((b, 1, cfg.d_model), generator=g).to(torch.float32 if grad else
                                                          L._dtype(cfg))
    shape = (b, lk, 2 * HKV if strided else HKV, HD)
    rows = [torch.randn(shape, generator=g).to(cache_dtype or L._dtype(cfg))
            for _ in range(2)]
    if strided:
        rows = [r[:, :, :HKV] for r in rows]
    pos = torch.tensor(cache_pos, dtype=torch.int32)
    if grad:
        p = {n: w.requires_grad_() for n, w in p.items()}
    with torch.set_grad_enabled(grad):
        out, (ck, cv) = L.attention(p, x, pos[:, None], cfg, cache=tuple(rows),
                                    cache_pos=pos)
    return out.detach(), (ck, cv)


# row 0 full, a ragged row, a row of length 1, a parked row (past the row),
# a row one short of full
def _positions(lk):
    return [lk - 1, lk // 3, 0, lk + 3, lk - 2]


@pytest.mark.parametrize("rep", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_routed_decode_matches_sdpa(monkeypatch, dtype, rep):
    cfg, lk = _cfg(rep, dtype), 96                           # 3 pages of 32
    calls = _Calls(monkeypatch)
    got, rows = _decode(cfg, _positions(lk), lk)
    assert calls.n == 1
    monkeypatch.setattr(L, "rows_decode_takes", lambda *a: False)
    want, rows_plain = _decode(cfg, _positions(lk), lk)
    assert calls.n == 1
    assert got.dtype == want.dtype == L._dtype(cfg)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for a, b in zip(rows, rows_plain):                       # the same writes
        assert torch.equal(a, b)


@pytest.mark.parametrize("pos", [[3, 9, 0], [15, 16, 40], [12, 31, 17]],
                         ids=["before_wrap", "at_wrap", "after_wrap"])
def test_ring_decode_matches_sdpa(monkeypatch, pos):
    """An SWA ring of 16 slots (``init_cache`` caps the rows at the window):
    before its first wrap a row reads its first pos + 1 slots, after it all
    16, on both routes."""
    cfg = _cfg(3, torch.float32, window=16)
    calls = _Calls(monkeypatch)
    g = torch.Generator().manual_seed(1)
    p = L.attention_init(g, cfg)
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    rows = [torch.randn((3, 16, HKV, HD), generator=g).to(torch.bfloat16) for _ in range(2)]
    positions = torch.tensor(pos, dtype=torch.int32)

    def run():
        return L.attention(p, x, positions[:, None], cfg, cache=tuple(r.clone() for r in rows),
                           cache_pos=positions % 16)[0]
    got = run()
    assert calls.n == 1
    monkeypatch.setattr(L, "rows_decode_takes", lambda *a: False)
    torch.testing.assert_close(got, run(), **TOL[torch.float32])
    assert calls.n == 1


@pytest.mark.parametrize("b,lk,blk", [(3, 64, 64), (2, 576, 64), (128, 5120, 256),
                                      (64, 7168, 256), (4, 48, 16)])
def test_fixed_table_covers_every_slot_of_every_row_once(b, lk, blk):
    assert L.rows_block(lk) == blk
    table = L._rows_table(b, lk // blk, torch.device("cpu"))
    assert table is L._rows_table(b, lk // blk, torch.device("cpu"))      # made once
    assert table.dtype == torch.int32 and tuple(table.shape) == (b, lk // blk)
    assert torch.equal(table.flatten().sort().values, torch.arange(b * lk // blk,
                                                                  dtype=torch.int32))
    rows = torch.arange(b * lk).view(b, lk, 1, 1)
    arena = rows.view(b * lk // blk, blk, 1, 1)
    assert torch.equal(arena[table.long()].reshape(b, lk, 1, 1), rows)


@pytest.mark.parametrize("case", ["rep5", "L100", "autograd", "bf16_q_f32_cache",
                                  "strided_rows"])
def test_shapes_the_kernel_does_not_take_keep_sdpa(monkeypatch, case):
    """rep 5 is no group the kernel is built for; 100 slots split into no
    page of 16..256; a step under autograd, a bf16 query over an f32 cache
    and rows that are not contiguous are none of the kernel's inputs."""
    rep = 5 if case == "rep5" else 3
    lk = 100 if case == "L100" else 64
    dtype = torch.bfloat16 if case == "bf16_q_f32_cache" else torch.float32
    kw = dict(grad=case == "autograd", strided=case == "strided_rows",
              cache_dtype=torch.float32 if case == "bf16_q_f32_cache" else None)
    calls = _Calls(monkeypatch)
    got, _ = _decode(_cfg(rep, dtype), _positions(lk), lk, **kw)
    assert calls.n == 0
    monkeypatch.setattr(L, "rows_decode_takes", lambda *a: False)
    want, _ = _decode(_cfg(rep, dtype), _positions(lk), lk, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_served_tokens_equal_the_plain_route(monkeypatch, dtype):
    """``Scheduler(paged=False)`` over rows of 48 slots: the same greedy
    tokens through the kernel's route as through ``_sdpa``, one kernel call
    a layer and a decode step; an empty prompt with gen == max_len parks at
    pos == max_len while the other slot decodes."""
    cfg = configs.reduced(configs.get("chatglm3-6b")).replace(dtype=str(dtype)[6:], vocab=64)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    spec = [(0, 48, 0), (9, 12, 0), (5, 20, 3), (17, 6, 8), (2, 9, 9)]

    def serve():
        reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, (lp,)).astype(np.int32),
                        gen=g, arrival=a) for i, (lp, g, a) in enumerate(spec)]
        return Scheduler(cfg, params, slots=2, max_len=48, bucket=4).run(reqs)
    state = rng.get_state()
    calls = _Calls(monkeypatch)
    got = serve()
    assert calls.n == got["decode_steps"] * cfg.n_layers > 0
    rng.set_state(state)
    monkeypatch.setattr(L, "rows_decode_takes", lambda *a: False)
    want = serve()
    assert calls.n == got["decode_steps"] * cfg.n_layers
    for i, (_, gen, _) in enumerate(spec):
        assert got["completions"][i].tokens == want["completions"][i].tokens, i
        assert len(got["completions"][i].tokens) == gen


@pytest.mark.parametrize("window,pos", [(None, 21), (16, 9), (16, 37)],
                         ids=["full", "ring_before_wrap", "ring_after_wrap"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_scalar_position_decode_matches_per_row(monkeypatch, dtype, window, pos):
    """A one-process decode step at one scalar position writes and reads as
    the same step at that position given per row: the same rows after the
    write, the same greedy tokens, logits within the kernel's bound.  Only
    the per-row step reads through the kernel, one call a layer."""
    cfg = configs.reduced(configs.get("chatglm3-6b")).replace(dtype=str(dtype)[6:], vocab=64,
                                                              window=window)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    b, max_len = 3, 48
    g = torch.Generator().manual_seed(2)
    cache = [tuple(torch.randn((b, min(max_len, window or max_len), cfg.n_kv_heads, cfg.hd),
                               generator=g).to(torch.bfloat16) for _ in range(2))
             for _ in range(cfg.n_layers)]
    token = torch.randint(0, cfg.vocab, (b,), generator=g, dtype=torch.int32)

    def step(at):
        rows = [tuple(t.clone() for t in kv) for kv in cache]
        return T.decode_step(params, token, rows, at, cfg)
    calls = _Calls(monkeypatch)
    got, got_rows = step(torch.tensor(pos))
    assert calls.n == 0
    want, want_rows = step(torch.full((b,), pos))
    assert calls.n == cfg.n_layers
    for a, w in zip(got_rows, want_rows):
        assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(got, want, **TOL[dtype])
