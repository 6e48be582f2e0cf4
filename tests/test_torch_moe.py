"""The port's MoE layer against the JAX package's (``repro.models.moe``):
``moe_ffn`` on one process (f32 and bf16, with and without a shared
expert), the load-balance loss, the expert-parallel body's capacity drops
on each shard of a rank group, and three traps: the router and experts'
dtypes, top-k / stable-sort order on ties, and a combine without atomics.

JAX initialises the parameters; ``repro_torch.convert`` carries them over.
Tolerances: f32 1e-5 (summation order only), bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import config as jconfig
from repro.models import moe as JM
from repro_torch import config
from repro_torch.convert import params_from_jax
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
