"""The dry run's cells on the production mesh (16, 16) against the JAX
package's layout, and every cell's step run on ``meta``.

* For each of the 33 cells that are not skipped, the bytes a rank holds
  (the train state, or the parameters and the cache, and a train cell's
  batch rows) equal the sum of JAX's per-device blocks under its
  ``param_specs`` / ``opt_specs`` (``train_state_shardings``) and cache
  specs on ``compat.abstract_mesh``, from ``jax.eval_shape`` only, both
  on the port's planner's layout (on H100 constants it may differ from
  the one JAX's planner picks on its own).  JAX stacks
  each layer's leaves over the periods and the port does not, so a leaf
  may be split on another dim (ROADMAP queue 3: ZeRO's scatter dim); the
  bytes a rank holds are compared leaf kind by leaf kind, and no cell has
  a leaf whose bytes differ.  A serve step takes the global token inputs
  (it cuts its rows itself), so those are not compared.
* ``sharding_dropped`` equals JAX's ``dropped_partition_report()`` with
  the port's unstacked leaves restacked: layer i of the port is JAX's
  ``layers/<i % period>`` leaf (``enc_layers`` / ``dec_layers`` have no
  index), its dim one further and its shape with the stacked count first.
* Every cell's step runs on ``meta`` at full width on the rank at the
  mesh's last coordinate, at one period of depth (Whisper whole): finite
  FLOPs, bytes, memory and collectives; the prefill cells' flash launches
  equal their attention layers (Whisper's encoder and decoder); the MoE
  cells route ``"balanced"``.  The xLSTM cells are in
  ``test_torch_dryrun_xlstm.py`` and ``test_torch_dryrun_xlstm_prefill.py``
  (its sLSTM runs a step a token).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.config import SHAPES as JSHAPES
from repro.config import ParallelConfig as JParallelConfig
from repro.core.compat import abstract_mesh
from repro.launch import specs as jspecs
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.parallel import sharding as jsharding
from repro.parallel import steps as JS
from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding
from repro_torch.tree import leaves_with_path

MESH, AXES = (16, 16), ("data", "model")
CELLS = [(a, s) for a, s, skip in configs.cells() if not skip]
SLOW = {"xlstm-1.3b"}


def _jax_block_bytes(tree, shardings, mesh_sizes) -> dict:
    """Bytes of each leaf's per-device block, keyed by its restacked path."""
    out = {}
    for (path, leaf), sh in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree.leaves(shardings)):
        spec = getattr(sh, "spec", sh)
        shard = 1
        for part in spec:
            for a in (() if part is None else part if isinstance(part, tuple) else (part,)):
                shard *= mesh_sizes[a]
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = out.get(name, 0) + math.prod(leaf.shape) * leaf.dtype.itemsize // shard
    return out


def _restack(path, cfg) -> str:
    """A port leaf's path as JAX names the stacked leaf it belongs to:
    ``layers/<i>`` is ``layers/<i % period>``, ``enc_layers/<i>`` and
    ``dec_layers/<i>`` are ``enc_layers`` and ``dec_layers``."""
    parts = [str(p) for p in path]
    for j, part in enumerate(parts[:-1]):
        if part == "layers" and not cfg.enc_dec:
            parts[j + 1] = str(int(parts[j + 1]) % len(cfg.block_pattern))
            break
        if part in ("enc_layers", "dec_layers"):
            del parts[j + 1]
            break
    return "/".join(parts)


def _port_block_bytes(tree, cfg) -> dict:
    out = {}
    for path, leaf in leaves_with_path(tree):
        name = _restack(path, cfg)
        out[name] = out.get(name, 0) + leaf.numel() * leaf.element_size()
    return out


def _restacked_drops(report, cfg) -> list:
    """The port's report as JAX's: one entry a stacked leaf and dim."""
    out = {}
    for e in report:
        parts = e["leaf"].split("/")
        if not {"layers", "enc_layers", "dec_layers"} & set(parts):   # not a layer's
            out[(e["leaf"], e["dim"])] = e
            continue
        leaf = _restack(parts, cfg)
        n = cfg.n_layers if cfg.enc_dec else cfg.n_periods
        out[(leaf, e["dim"] + 1)] = dict(leaf=leaf, dim=e["dim"] + 1,
                                         shape=(n,) + tuple(e["shape"]), axes=e["axes"],
                                         shard=e["shard"])
    return [out[k] for k in sorted(out)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arguments_and_dropped_partitions_equal_jax(arch, shape):
    kind = SHAPES[shape].kind
    pcfg = dryrun.default_pcfg(arch, kind)
    jpcfg = JParallelConfig(**dataclasses.asdict(pcfg))
    mesh = dryrun.recording_mesh()
    sharding.reset_dropped_partitions()
    cell, cfg, _, _, _, parts = dryrun.prepare_cell(arch, shape, mesh, pcfg)
    got_drops = sharding.dropped_partition_report()

    jcfg = jconfigs.get(arch)
    if kind != "train":
        jcfg = jcfg.replace(param_dtype="bfloat16")
    jmesh = abstract_mesh(MESH, AXES)
    sizes = dict(zip(AXES, MESH))
    jsharding.reset_dropped_partitions()
    jcell = jspecs.build_cell(jcfg, JSHAPES[shape], jmesh, jpcfg)
    if kind == "train":
        jstate = JS.abstract_train_state(jcfg, jpcfg)
        want = _jax_block_bytes(jstate, JS.train_state_shardings(jcfg, jpcfg, jcell.ctx, jstate),
                                sizes)
        assert _jax_block_bytes(jcell.abstract_args[0], jcell.in_shardings[0], sizes) == \
            _port_block_bytes(parts["inputs"], cfg)
        got = _port_block_bytes(parts["state"], cfg)
    else:
        init = JE.init if jcfg.enc_dec else JT.init
        jparams = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
        want = _jax_block_bytes(jparams, jsharding.to_shardings(
            jsharding.param_specs(jparams, jcfg, jcell.ctx), jmesh), sizes)
        got = _port_block_bytes(parts["state"], cfg)
        jcache = _jax_block_bytes(jcell.abstract_args[1], jcell.in_shardings[1], sizes)
        pcache = _port_block_bytes(parts["cache"], cfg)
        assert sum(pcache.values()) == sum(jcache.values())
    want_drops = jsharding.dropped_partition_report()
    assert set(got) == set(want)
    differ = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert differ == {}, differ
    assert _restacked_drops(got_drops, cfg) == [
        dict(e, shape=tuple(e["shape"]), axes=tuple(e["axes"])) for e in want_drops]


def _period_cfg(arch, kind):
    cfg = dryrun._cell_cfg(arch, kind)
    return cfg if cfg.enc_dec else cfg.replace(n_layers=len(cfg.block_pattern))


def check_cell_runs(arch, shape):
    """One rank's step of the cell at one period of depth, on ``meta``."""
    kind = SHAPES[shape].kind
    cfg = _period_cfg(arch, kind)
    raw = dryrun.trace_cell(arch, shape, dryrun.recording_mesh(), cfg_override=cfg)
    assert raw["cell"].ctx.mesh.rank == 255
    for key in ("flops", "bytes", "staged_bytes"):
        assert np.isfinite(raw[key]) and raw[key] > 0, key
    mem = raw["memory"]
    assert mem["argument_bytes"] == sum(mem["arguments"].values()) > 0
    assert mem["temp_bytes"] > 0 and mem["peak_estimate_bytes"] > mem["argument_bytes"]
    assert raw["collectives"]["wire_bytes"] > 0
    attn = sum(k in ("attn", "attn_moe", "mamba2_attn") for k in cfg.block_pattern)
    flash = sum(raw["kernel_launches"].values())
    if kind == "prefill":
        assert flash == (2 * cfg.n_layers if cfg.enc_dec else attn * cfg.n_periods)
        assert (raw["kernel_flops"] > 0) == (flash > 0)
        logits = raw["out"][0]
        assert tuple(logits.shape) == (SHAPES[shape].global_batch, cfg.vocab)
    else:
        assert flash == 0
    if kind == "decode":
        assert tuple(raw["out"][0].shape) == (SHAPES[shape].global_batch,)
    if kind == "train":
        assert raw["memory"]["alias_bytes"] == mem["arguments"]["state"]
    else:     # the attention caches are written in place, a recurrent state anew
        assert 0 <= raw["memory"]["alias_bytes"] <= mem["arguments"]["cache"]
    assert (dryrun._routing(cfg) == "balanced") == (cfg.moe is not None)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if c[0] not in SLOW])
def test_cell_step_runs_on_meta(arch, shape):
    check_cell_runs(arch, shape)
