"""The port's optimizer and schedule against the JAX package's.

The same numpy parameters and gradients, made from a seed, go through
JAX's and the port's AdamW (f32 moments, bf16 moments, an f32 master copy),
global-norm clip and warmup-cosine schedule.  Both do all the arithmetic in
f32 in the same order; they may differ in the last bit where one fuses a
multiply-add, so values are held to a relative error of 1e-6.  The step
counter is an integer and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim
from repro_torch.tree import leaves, tree_map

REL = 1e-6


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(dtype), "b": rng.randn(5).astype(dtype),
            "layers": ({"k": rng.randn(3, 4, 2).astype(dtype)},
                       {"k": rng.randn(3, 4, 2).astype(dtype)})}


def _to_torch(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        dtype or torch.float32), tree)


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got, want, rel=REL):
    g = [t.float().numpy() for t in leaves(got)]
    w = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("state_dtype,master", [("float32", False), ("bfloat16", False),
                                                ("float32", True)])
def test_adamw_matches_jax(state_dtype, master):
    """Three AdamW steps on identical grads; the master variant keeps bf16
    parameters beside the f32 copy, as ``init_train_state`` does."""
    p_np = _tree(0)
    pdt_t, pdt_j = (torch.bfloat16, jnp.bfloat16) if master else (torch.float32, jnp.float32)
    jp = _to_jax(p_np)
    tp = _to_torch(p_np)
    jst, st = jopt.adamw_init(jp, state_dtype, master=master), optim.adamw_init(
        tp, state_dtype, master=master)
    jp, tp = _to_jax(p_np, pdt_j), _to_torch(p_np, pdt_t)
    for step in range(3):
        g_np = _tree(10 + step)
        jp, jst = jopt.adamw_update(_to_jax(g_np), jst, jp, lr=1e-2, weight_decay=0.1)
        tp, st = optim.adamw_update(_to_torch(g_np), st, tp, lr=1e-2, weight_decay=0.1)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == int(jst["step"]) == 3
    _close(tp, jp)
    for k in ("m", "v"):
        assert leaves(st[k])[0].dtype == (torch.bfloat16 if state_dtype == "bfloat16"
                                          else torch.float32)
        _close(st[k], jst[k])
    if master:
        _close(st["master"], jst["master"])


def test_adamw_update_writes_in_place():
    """The update writes into the state's own tensors (JAX's step donates
    them) and computes what it computes on a copy of that state."""
    p = _to_torch(_tree(0))
    st = optim.adamw_init(p, master=True)
    g = _to_torch(_tree(1))
    want_p, want_st = optim.adamw_update(g, tree_map(torch.clone, st),
                                         tree_map(torch.clone, p), lr=1e-2)
    before = [t.data_ptr() for t in leaves((p, st))]
    got_p, got_st = optim.adamw_update(g, st, p, lr=1e-2)
    assert got_p is p and got_st is st
    assert [t.data_ptr() for t in leaves((got_p, got_st))] == before
    assert int(st["step"]) == 1
    for a, b in zip(leaves((got_p, got_st)), leaves((want_p, want_st))):
        assert torch.equal(a, b)


def test_adamw_matches_reference():
    """One AdamW step vs a hand-rolled numpy reference (the JAX package's
    ``test_adamw_matches_reference``)."""
    p = {"a": torch.tensor([1.0, -2.0, 3.0]), "nested": {"b": torch.ones((2, 2))}}
    g = tree_map(lambda x: 0.1 * torch.ones_like(x), p)
    st = optim.adamw_init(p)
    lr, eps, wd = 0.1, 1e-8, 0.1
    newp, newst = optim.adamw_update(g, st, p, lr=lr, b1=0.9, b2=0.95, weight_decay=wd)
    m, v = 0.1 * 0.1, 0.05 * 0.01
    mh, vh = m / 0.1, v / 0.05
    delta = mh / (np.sqrt(vh) + eps) + wd * 1.0          # the matrix leaf decays
    np.testing.assert_allclose(newp["nested"]["b"].numpy(), 1.0 - lr * delta, rtol=1e-5)
    delta_v = mh / (np.sqrt(vh) + eps)                   # the vector leaf does not
    np.testing.assert_allclose(newp["a"].numpy()[0], 1.0 - lr * delta_v, rtol=1e-5)
    assert int(newst["step"]) == 1


def test_adamw_bf16_states():
    p = {"w": torch.ones((4, 4))}
    st = optim.adamw_init(p, state_dtype="bfloat16")
    assert st["m"]["w"].dtype == torch.bfloat16
    newp, newst = optim.adamw_update({"w": torch.full((4, 4), 0.5)}, st, p, lr=0.01)
    assert newst["v"]["w"].dtype == torch.bfloat16
    assert bool((newp["w"] < 1.0).all())


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e4])
def test_clip_and_global_norm_match_jax(max_norm):
    g_np = _tree(3)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tg, tn = optim.clip_by_global_norm(_to_torch(g_np, dtype), max_norm)
        jg, jn = jopt.clip_by_global_norm(_to_jax(g_np, jdtype), max_norm)
        assert tn.dtype == torch.float32
        np.testing.assert_allclose(float(tn), float(jn), rtol=REL)
        assert all(t.dtype == dtype for t in leaves(tg))
        _close(tg, jg)
    np.testing.assert_allclose(float(optim.global_norm(_to_torch(g_np))),
                               float(jopt.global_norm(_to_jax(g_np))), rtol=REL)


def test_clip_by_global_norm():
    clipped, norm = optim.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(1000.0), rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0, rtol=1e-4)


@pytest.mark.parametrize("warmup,total", [(10, 100), (100, 1000), (0, 8), (2, 8)])
def test_schedule_matches_jax(warmup, total):
    for s in list(range(0, 12)) + [total // 2, total - 1, total, total + 5]:
        kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total)
        want = float(jopt.warmup_cosine(jnp.int32(s), **kw))
        got = optim.warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=REL)


def test_schedule_shape():
    lrs = [float(optim.warmup_cosine(torch.tensor(s, dtype=torch.int32), lr=1.0,
                                     warmup_steps=10, total_steps=100)) for s in range(100)]
    assert lrs[0] == pytest.approx(0.1) and abs(lrs[10] - 1.0) < 0.11
    assert lrs[99] < 0.2 and all(lr >= 0 for lr in lrs)
