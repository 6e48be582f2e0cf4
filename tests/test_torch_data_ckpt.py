"""The port's data pipeline and checkpoints against the JAX package's.

Batches are a pure function of (seed, step) in both packages and must be
bit-identical.  Checkpoints share one on-disk layout: a checkpoint JAX
writes is read by the port, and one the port writes is read by JAX, on a
tree with f32, bf16 and int32 leaves and a tuple.  numpy has no bfloat16
of its own: JAX writes its bf16 leaves with a void ``|V2`` header (what
``np.load`` returns for them), the port a ``uint16`` pattern; both hold the
same 16 bits, and the manifest says ``bfloat16``.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.config import ShapeConfig as JShape
from repro.data import make_batch_iterator as jbatches
from repro.data.pipeline import SyntheticTokens as JTokens
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.config import ShapeConfig
from repro_torch.data import make_batch_iterator
from repro_torch.data.pipeline import SyntheticTokens


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 32, 8, 3), (128256, 256, 4, 0),
                                                  (512, 62, 3, 12345)])
def test_batch_at_bitwise_equal_to_jax(vocab, seq, batch, seed):
    """(An odd ``seq_len`` raises in both: the repeated half is one short.)"""
    mine, ref = SyntheticTokens(vocab, seq, batch, seed), JTokens(vocab, seq, batch, seed)
    for step in (0, 1, 5, 1000):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mine.batch_at(step, 1, batch), ref.batch_at(step, 1, batch))


def test_batch_iterator_bitwise_equal_to_jax():
    cfg = configs.reduced(configs.get("llama3.2-3b"))
    jcfg = jconfigs.get("llama3.2-3b").replace(vocab=cfg.vocab)
    mine = make_batch_iterator(cfg, ShapeConfig("t", "train", 64, 4), seed=7, start_step=3,
                               device="cpu")
    ref = jbatches(jcfg, JShape("t", "train", 64, 4), seed=7, start_step=3)
    for _ in range(4):
        got, want = next(mine), next(ref)
        assert got["tokens"].dtype == torch.int32 and got["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    mine.close()
    ref.close()


def test_batch_iterator_raises_a_producer_error():
    """An error in the prefetch thread reaches the consumer (here: a device
    that does not exist), instead of leaving it waiting forever."""
    cfg = configs.reduced(configs.get("llama3.2-3b"))
    it = make_batch_iterator(cfg, ShapeConfig("t", "train", 8, 2), device="no_such_device")
    with pytest.raises(RuntimeError):
        next(it)


def test_data_deterministic_and_elastic():
    ds = SyntheticTokens(vocab=100, seq_len=32, global_batch=8, seed=3)
    b1 = ds.batch_at(5)
    np.testing.assert_array_equal(b1, ds.batch_at(5))
    assert not np.array_equal(b1, ds.batch_at(6))
    np.testing.assert_array_equal(ds.batch_at(5, 2, 6), b1[2:6])
    np.testing.assert_array_equal(np.concatenate([ds.batch_at(5, 0, 4), ds.batch_at(5, 4, 8)]),
                                  b1)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _np_tree():
    rng = np.random.RandomState(0)
    return {"params": {"w": rng.randn(3, 4).astype(np.float32),
                       "e": rng.randn(5, 2).astype(ml_dtypes.bfloat16)},
            "opt": {"step": np.int32(7)},
            "layers": ({"a": rng.randn(2).astype(np.float32)},
                       {"a": np.arange(4, dtype=np.int32)})}


def _torch_tree(t):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, t)


def _bits(x):
    """A leaf's 16/32-bit pattern and dtype name, for exact comparison."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def test_port_reads_a_jax_checkpoint(tmp_path):
    tree = _np_tree()
    d = str(tmp_path / "jax")
    jckpt.save_checkpoint(d, 7, jax.tree.map(jnp.asarray, tree))
    # JAX's bf16 leaf on disk: 16-bit void records, which np.load returns
    assert np.load(os.path.join(d, "step_7", "params__e.proc0.npy")).dtype == np.dtype("V2")
    assert ckpt.latest_step(d) == 7
    got = ckpt.restore_checkpoint(d, 7, _torch_tree(tree))
    assert got["params"]["e"].dtype == torch.bfloat16 and isinstance(got["layers"], tuple)
    for g, w in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor), jax.tree.leaves(tree)):
        (gb, gd), (wb, wd) = _bits(g), _bits(w)
        assert gd == wd
        np.testing.assert_array_equal(gb, wb)


def test_jax_reads_a_port_checkpoint(tmp_path):
    """JAX's restore reads every leaf the port wrote; it returns a bf16 leaf
    as its uint16 pattern (JAX's restore keeps the stored dtype and does
    not read the manifest's), whose bits are the port's bf16 values."""
    tree = _np_tree()
    d = str(tmp_path / "port")
    ckpt.save_checkpoint(d, 7, _torch_tree(tree))
    with open(os.path.join(d, "step_7", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["leaves"]["params__e"] == {"shape": [5, 2], "dtype": "bfloat16"}
    assert manifest["leaves"]["opt__step"] == {"shape": [], "dtype": "int32"}
    assert jckpt.latest_step(d) == 7
    got = jckpt.restore_checkpoint(d, 7, jax.tree.map(jnp.asarray, tree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        wb, wd = _bits(w)
        g = np.asarray(g)
        if wd == "bfloat16":
            assert g.dtype == np.uint16
        np.testing.assert_array_equal(g, wb)


def test_manifest_equal_to_jax(tmp_path):
    tree = _np_tree()
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jax.tree.map(jnp.asarray, tree))
    ckpt.save_checkpoint(str(tmp_path / "p"), 1, _torch_tree(tree))
    read = lambda k: json.load(open(tmp_path / k / "step_1" / "manifest.json"))
    assert read("p") == read("j")
    assert sorted(os.listdir(tmp_path / "p" / "step_1")) == \
        sorted(os.listdir(tmp_path / "j" / "step_1"))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "h": torch.randn(3, generator=torch.Generator().manual_seed(0)
                                        ).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "layers": ({"a": torch.ones((2,))}, {"a": torch.zeros((2,))})}
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 7, tree)
    assert ckpt.latest_step(d) == 7 and ckpt.latest_step(str(tmp_path / "none")) is None
    restored = ckpt.restore_checkpoint(d, 7, tree)
    for a, b in zip(jax.tree.leaves(tree, is_leaf=torch.is_tensor),
                    jax.tree.leaves(restored, is_leaf=torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = jax.tree.map(lambda t: t.to("meta"), tree, is_leaf=torch.is_tensor)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, 7, meta)
    on_cpu = ckpt.restore_checkpoint(d, 7, meta, device="cpu")
    assert torch.equal(on_cpu["params"]["w"], tree["params"]["w"])


def test_checkpoint_async_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    saver = ckpt.AsyncCheckpointer(d)
    tree = {"x": torch.ones((4,))}
    saver.save(10, tree)
    tree["x"].mul_(2)                     # the host copy was taken before
    saver.save(20, tree)
    saver.wait()
    assert ckpt.latest_step(d) == 20 and saver.last_committed == 20
    np.testing.assert_array_equal(ckpt.restore_checkpoint(d, 10, tree)["x"].numpy(), np.ones(4))
    np.testing.assert_array_equal(ckpt.restore_checkpoint(d, 20, tree)["x"].numpy(),
                                  2 * np.ones(4))


def test_checkpoint_async_raises_a_failed_save(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(str(blocker))
    saver.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        saver.wait()
