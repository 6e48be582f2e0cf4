"""The port's MoE layer against the JAX package's (``repro.models.moe``):
``moe_ffn`` on one process (f32 and bf16, with and without a shared
expert), the load-balance loss, the expert-parallel body's capacity drops
on each shard of a rank group, and three traps: the router and experts'
dtypes, top-k / stable-sort order on ties, and a combine without atomics.
The grouped products' offsets interface (``kernels/grouped_matmul.py``, its
plain versions here) against JAX's ``lax.ragged_dot`` and the per-expert
loop in f32, its edge cases, and which calls take it.

JAX initialises the parameters; ``repro_torch.convert`` carries them over.
Tolerances: f32 1e-5 (summation order only), bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro import config as jconfig
from repro.models import moe as JM
from repro_torch import config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.models import moe as M

torch.backends.cuda.matmul.allow_tf32 = False

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(dtype="float32", n_experts=8, top_k=2, shared=1, cf=1.25):
    kw = dict(name="moe", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab=64, block_pattern=("attn_moe",), dtype=dtype)
    mk = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=16, n_shared_experts=shared,
              capacity_factor=cf)
    return (jconfig.ModelConfig(**kw, moe=jconfig.MoEConfig(**mk)),
            config.ModelConfig(**kw, moe=config.MoEConfig(**mk)))


def _params(jcfg, cfg, seed=0):
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    tree = {"layers": ({"moe": jax.tree.map(lambda a: np.asarray(a)[None], jp)},),
            "embed": {}, "final_norm": {}}
    return jp, params_from_jax(tree, cfg, device="cpu")["layers"][0]["moe"]


def _x(dtype, b=4, s=6, seed=1):
    x = np.random.RandomState(seed).randn(b, s, 32).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,shared", [("float32", 1), ("float32", 0), ("bfloat16", 1)])
def test_moe_ffn_matches_jax(dtype, shared):
    jcfg, cfg = _cfgs(dtype, shared=shared)
    jp, p = _params(jcfg, cfg)
    jx, x = _x(dtype)
    want, wprobs = JM.moe_ffn(jp, jx, jcfg, None)
    got, probs = M.moe_ffn(p, x, cfg)
    assert got.dtype == getattr(torch, dtype) and probs.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])
    np.testing.assert_allclose(probs.numpy(), np.asarray(wprobs), **TOL["float32"])
    aux = M.load_balance_loss(probs)
    np.testing.assert_allclose(float(aux), float(JM.load_balance_loss(wprobs)), rtol=1e-5)


def test_moe_gradients_match_jax():
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg, cfg, seed=3)
    jx, x = _x("float32", seed=4)

    def jloss(jp, jx):
        out, probs = JM.moe_ffn(jp, jx, jcfg, None)
        return jnp.sum(out ** 2) + JM.load_balance_loss(probs)

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    live = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) else
                {n: w.clone().requires_grad_(True) for n, w in v.items()}) for k, v in p.items()}
    xl = x.clone().requires_grad_(True)
    out, probs = M.moe_ffn(live, xl, cfg)
    (torch.sum(out ** 2) + M.load_balance_loss(probs)).backward()
    np.testing.assert_allclose(xl.grad.numpy(), np.asarray(jg[1]), atol=1e-5, rtol=1e-4)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(live[name].grad.numpy(), np.asarray(jg[0][name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(live["shared"][name].grad.numpy(),
                                   np.asarray(jg[0]["shared"][name]), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("cf", [0.25, 0.5, 8.0])
def test_ep_body_capacity_drops_match_jax(cf):
    """The expert-parallel body on each of the 2 shards of a rank group,
    called without collectives: each shard's partial output (its experts'
    first-come assignments up to the capacity) as JAX's ``_moe_body_ep``.
    With room for every assignment the shards sum to ``moe_ffn``."""
    jcfg, cfg = _cfgs(cf=cf, shared=0)
    jp, p = _params(jcfg, cfg, seed=5)
    jx, x = _x("float32", seed=6)
    x_flat = x.reshape(-1, 32)
    top_i, weights, _ = M._route(x_flat, p["router"], 2)
    total = 0
    for shard in range(2):
        want, _ = JM._moe_body_ep(
            jx, jp["router"], *(jp[n][shard * 4:(shard + 1) * 4] for n in
                                ("w_gate", "w_up", "w_down")), None, cfg=jcfg, ep=2,
            my_shard=shard, fsdp_axes=(), model_axis=None)
        got = M._body_ep(x_flat, (top_i, weights),
                         *(p[n][shard * 4:(shard + 1) * 4] for n in ("w_gate", "w_up", "w_down")),
                         cfg, torch.float32, ep=2, shard=shard)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1, 32),
                                   **TOL["float32"])
        total = total + got
    full, _ = M.moe_ffn(p, x, cfg)
    kept = np.allclose(total.numpy(), full.reshape(-1, 32).numpy(), atol=1e-5)
    if cf > 1:
        assert kept                # room for all 48 assignments
    elif cf == 0.25:
        assert not kept            # 12 a shard of 48: drops


def test_convert_keeps_the_router_in_f32():
    """JAX draws the router in f32 whatever the model dtype; a bf16 model's
    router must not round to bf16 on the way over (routing would flip)."""
    jcfg, cfg = _cfgs("bfloat16")
    jp, p = _params(jcfg, cfg)
    assert p["router"].dtype == torch.float32
    np.testing.assert_array_equal(p["router"].numpy(), np.asarray(jp["router"]))
    assert p["w_gate"].dtype == p["shared"]["w_up"].dtype == torch.bfloat16
    mine = M.moe_init(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    assert mine["router"].dtype == torch.float32 and mine["w_down"].dtype == torch.bfloat16


def test_expert_leaves_drawn_in_slices_keep_their_shape(monkeypatch):
    _, cfg = _cfgs()
    monkeypatch.setattr(M, "_DRAW_ELEMS", 32 * 16 * 3)     # 3 experts a slice
    p = M.moe_init(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    assert p["w_gate"].shape == (8, 32, 16) and p["w_down"].shape == (8, 16, 32)
    std = float(p["w_down"].float().std())
    assert 0.2 < std < 0.3                                  # 1 / sqrt(16)


def test_top_k_and_stable_sort_pick_what_jax_picks():
    """``lax.top_k`` breaks ties by the lower index and ``jnp.argsort(stable=
    True)`` keeps equal keys in order; ``torch.topk`` does not promise the
    first, so the port sorts stably.  Random logits, logits with exact ties,
    and expert ids full of repeats."""
    r = np.random.RandomState(7)
    cases = [r.randn(64, 8).astype(np.float32),
             r.randint(0, 3, (64, 8)).astype(np.float32),
             np.zeros((4, 20), np.float32)]
    for logits in cases:
        for k in (1, 2, 4):
            jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
            v, i = M.top_k(torch.from_numpy(logits), k)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    ids = r.randint(0, 4, (200,)).astype(np.int32)
    np.testing.assert_array_equal(
        torch.argsort(torch.from_numpy(ids), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(ids), stable=True)))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        accumulate = func.__name__.startswith("index_put") and (
            kwargs.get("accumulate") or (len(args) > 3 and args[3]))
        self.seen.append(func.__name__ + ("(accumulate)" if accumulate else ""))
        return func(*args, **kwargs)


def test_combine_is_free_of_atomic_scatters():
    """CUDA ``index_add_`` / ``scatter_add_`` / accumulating ``index_put_``
    add with atomics, in no fixed order, so a train step would not repeat
    bit for bit (the launcher's recovery must).  The forward combines the
    experts' rows with a put and an in-order sum over the k slots; the only
    accumulating op of the backward is ``index_add`` (the transpose of the
    ``index_select`` gathers), which ``torch.use_deterministic_algorithms``
    makes deterministic on the card.  Two runs are bitwise equal here."""
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg, cfg)
    _, x = _x("float32")
    atomic = ("index_add", "scatter_add", "scatter_reduce", "put_", "(accumulate)")
    grads = []
    for _ in range(2):
        xl = x.clone().requires_grad_(True)
        with _Ops() as fwd:
            out, probs = M.moe_ffn(p, xl, cfg)
        with _Ops() as bwd:
            (out.sum() + M.load_balance_loss(probs)).backward()
        assert not [op for op in fwd.seen if any(a in op for a in atomic)], fwd.seen
        assert {op for op in bwd.seen if any(a in op for a in atomic)} <= {"index_add.default"}
        grads.append((out.detach(), xl.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# (E, k, d, ff) of tiny layers shaped as Mixtral-8x22B's (few wide experts,
# top-2), Mellum2-12B-A2.5B's (64 narrow experts, top-8) and Kimi-K2's (384
# experts, top-8: most get no row)
GROUPED_SHAPES = {"mixtral": (8, 2, 48, 128), "mellum2": (64, 8, 72, 24),
                  "kimi": (384, 8, 56, 16)}


def _grouped_case(e, k, d, ff, tokens, seed=0):
    """Rows sorted by routed expert (top-k of random logits), their sorted
    ids, the experts' f32 matrices, all from numpy."""
    r = np.random.RandomState(seed)
    top = np.argsort(-r.randn(tokens, e), axis=1, kind="stable")[:, :k].reshape(-1)
    order = np.argsort(top, kind="stable")
    eid = top[order]
    xs = r.randn(tokens * k, d).astype(np.float32)
    ws = [(r.randn(e, a, b) / np.sqrt(a)).astype(np.float32) for a, b in
          ((d, ff), (d, ff), (ff, d))]
    return xs, eid, ws


def _ragged(x, w, sizes):
    return np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(sizes, jnp.int32)))


@pytest.mark.parametrize("shape", sorted(GROUPED_SHAPES))
def test_grouped_offsets_interface_matches_ragged_dot_and_the_loop(shape):
    """The plain versions behind the offsets interface, gate+up with its
    SiLU epilogue and down, equal JAX's ragged_dot and the per-expert loop
    (``grouped_matmul.ragged_dot``) in f32, and the wrapper takes them on
    the CPU."""
    e, k, d, ff = GROUPED_SHAPES[shape]
    xs, eid, (wg, wu, wd) = _grouped_case(e, k, d, ff, tokens=24)
    sizes = np.bincount(eid, minlength=e)
    t_eid = torch.from_numpy(eid)
    offsets = M._offsets(t_eid, e)
    np.testing.assert_array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(sizes)]))
    assert offsets.dtype == torch.int32
    txs, twg, twu, twd = (torch.from_numpy(a) for a in (xs, wg, wu, wd))
    h = gm.grouped_gate_up(txs, twg, twu, offsets)
    y = gm.grouped_down(h, twd, offsets)
    want_h = np.asarray(jax.nn.silu(_ragged(xs, wg, sizes))) * _ragged(xs, wu, sizes)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL["float32"])
    np.testing.assert_allclose(y.numpy(), _ragged(want_h, wd, sizes), **TOL["float32"])
    n = sizes.tolist()
    loop_h = F.silu(gm.ragged_dot(txs, twg, n)) * gm.ragged_dot(txs, twu, n)
    torch.testing.assert_close(h, loop_h, **TOL["float32"])
    torch.testing.assert_close(y, gm.ragged_dot(loop_h, twd, n), **TOL["float32"])
    torch.testing.assert_close(y, gm.ragged_swiglu(txs, twg, twu, twd, n), **TOL["float32"])
    assert torch.equal(h, gm.grouped_gate_up_ref(txs, twg, twu, offsets))
    assert torch.equal(y, gm.grouped_down_ref(h, twd, offsets))
    # the down product's scatter: rows put at their slots, weighted, in f32;
    # two slots no row lists stay 0
    rows = xs.shape[0]
    r = np.random.RandomState(1)
    slots = torch.from_numpy(r.permutation(rows + 2)[:rows])
    scale = torch.from_numpy(r.rand(rows + 2).astype(np.float32))
    full = gm.grouped_down(h, twd, offsets, slots, scale)
    want = np.zeros((rows + 2, d), np.float32)
    want[slots.numpy()] = y.numpy() * scale.numpy()[slots.numpy(), None]
    np.testing.assert_array_equal(full.numpy(), want)


@pytest.mark.parametrize("case", ["empty experts", "one expert", "rows past the groups"])
def test_grouped_offsets_edge_cases(case):
    """Experts with no row, every row in one expert, and rows at or past
    ``offsets[E]`` (the token-routing layout's padding), which give exactly
    0, as ragged_dot gives them."""
    e, d, ff, rows = 6, 16, 8, 20
    r = np.random.RandomState(2)
    xs = r.randn(rows, d).astype(np.float32)
    wg, wu = (r.randn(e, d, ff).astype(np.float32) for _ in range(2))
    wd = r.randn(e, ff, d).astype(np.float32)
    sizes = {"empty experts": [0, 7, 0, 0, 13, 0], "one expert": [0, 0, 20, 0, 0, 0],
             "rows past the groups": [3, 0, 5, 4, 0, 1]}[case]
    eid = np.repeat(np.arange(e + 1), sizes + [rows - sum(sizes)])
    offsets = M._offsets(torch.from_numpy(eid), e)
    assert offsets.tolist() == [0] + np.cumsum(sizes).tolist()
    txs, twg, twu, twd = (torch.from_numpy(a) for a in (xs, wg, wu, wd))
    h = gm.grouped_gate_up(txs, twg, twu, offsets)
    y = gm.grouped_down(h, twd, offsets)
    want_h = np.asarray(jax.nn.silu(_ragged(xs, wg, sizes))) * _ragged(xs, wu, sizes)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL["float32"])
    np.testing.assert_allclose(y.numpy(), _ragged(want_h, wd, sizes), **TOL["float32"])
    past = sum(sizes)
    assert not h[past:].any() and not y[past:].any()
    assert (past == rows) == (case != "rows past the groups")


def test_grouped_wrapper_checks_and_row_tile():
    """The wrapper raises on what neither route takes (no fallback), the
    kernels take nothing on the CPU, and the row tile holds twice the mean
    rows an expert: 16 at Mellum2's decode (512 assignments over 64), 128
    (the largest) at its prefill and at Mixtral's, 8 (the smallest) at
    Kimi-K2's decode."""
    xs = torch.zeros((10, 16))
    w = torch.zeros((4, 16, 8))
    off = torch.tensor([0, 2, 5, 5, 10], dtype=torch.int32)
    assert gm.grouped_gate_up(xs, w, w, off).shape == (10, 8)
    with pytest.raises(ValueError, match="offsets"):
        gm.grouped_gate_up(xs, w, w, off.long())
    with pytest.raises(ValueError, match="offsets"):
        gm.grouped_down(xs[:, :8], w.transpose(1, 2), off[:-1])
    with pytest.raises(ValueError, match="need rows"):
        gm.grouped_down(xs, w.transpose(1, 2), off)
    with pytest.raises(ValueError, match="kernel takes"):
        gm.grouped_gate_up(xs, w, w.to("meta"), off)
    with pytest.raises(ValueError, match="together"):
        gm.grouped_down(xs[:, :8], w.transpose(1, 2).contiguous(), off, slots=off.long())
    with pytest.raises(ValueError, match="slots"):
        gm.grouped_down(xs[:, :8], w.transpose(1, 2).contiguous(), off, off.long(),
                        torch.ones(10))
    assert not gm.takes(xs.bfloat16(), w.bfloat16())
    assert [gm.row_tile(r, e) for r, e in ((512, 64), (12000, 64), (3000, 8), (512, 384))] == \
        [16, 128, 128, 8]


def test_expert_ffn_routes_by_what_the_call_is(monkeypatch):
    """``meta`` calls (the dry run's balanced groups) and calls that
    autograd records (the kernels have no backward) take the per-expert
    loop; every other call takes the offsets interface, which reads no
    group size back to the host while no profile records."""
    jcfg, cfg = _cfgs(shared=0)
    _, p = _params(jcfg, cfg)
    _, x = _x("float32")
    seen = []
    loop, gate_up, sizes = gm.ragged_swiglu, gm.grouped_gate_up, M._sizes
    monkeypatch.setattr(gm, "ragged_swiglu", lambda *a: seen.append("loop") or loop(*a))
    monkeypatch.setattr(gm, "grouped_gate_up", lambda *a: seen.append("offsets") or gate_up(*a))
    monkeypatch.setattr(M, "_sizes", lambda *a: seen.append("sizes") or sizes(*a))
    with torch.no_grad():
        want, _ = M.moe_ffn(p, x, cfg)
    assert seen == ["offsets"]
    seen.clear()
    got, _ = M.moe_ffn(p, x.clone().requires_grad_(True), cfg)
    assert seen == ["sizes", "loop"]
    torch.testing.assert_close(got.detach(), want, **TOL["float32"])
    seen.clear()
    live = {n: (w.clone().requires_grad_(True) if n == "w_up" else w) for n, w in p.items()}
    M.moe_ffn(live, x, cfg)
    assert seen == ["sizes", "loop"]
    seen.clear()
    meta = {n: w.to("meta") for n, w in p.items()}
    with torch.no_grad():
        out, _ = M.moe_ffn(meta, x.to("meta"), cfg)
    assert out.device.type == "meta" and seen == ["sizes", "loop"]


class _OnCard:
    """What ``moe._on_loop`` reads of a tensor on the card: its device,
    dtype and autograd flag, and a layout the kernels may not take."""

    def __init__(self, dtype, contiguous=True):
        self.device, self.is_cuda, self.dtype = torch.device("cuda", 0), True, dtype
        self.requires_grad, self.contiguous = False, contiguous

    def is_contiguous(self):
        return self.contiguous


@pytest.mark.parametrize("dtype,contiguous,loop", [
    (torch.bfloat16, True, False), (torch.bfloat16, False, False),
    (torch.float16, True, False), (torch.float32, True, True)])
def test_on_card_route_follows_precision_not_layout(dtype, contiguous, loop):
    """On the card only f32 arithmetic takes the per-expert loop: a bf16 (or
    f16) call goes to the kernels whatever its weights' layout, so a layout
    they do not take raises in the wrapper instead of falling back."""
    xs = _OnCard(dtype)
    ws = (_OnCard(dtype, contiguous), _OnCard(dtype), _OnCard(dtype))
    with torch.no_grad():
        assert M._on_loop(xs, ws) is loop
