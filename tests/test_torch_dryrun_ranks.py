"""The recording mesh's staging count against ``ProcessMesh``'s, on 2 CPU
gloo ranks.

A reduced Llama (2 layers) on the mesh (1, 2): one train step of the
tensor-parallel layout under full remat, with and without
``sequence_parallel``, and one fused prefill into the L-sharded cache (16
slots split over ``model``), each run for real on both ranks, the bytes
each rank's ``ProcessMesh`` staged through the host read around the step.
The same steps run on ``meta`` through ``launch.dryrun.trace_cell`` on a
``RecordingMesh`` at each rank's coordinates: the recorded
``staged_bytes`` must equal the ranks' to the byte.  The recording mesh
counts by its own rule, sharing no code with ``ProcessMesh``'s count.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.config import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.core.mesh import RecordingMesh, launch
from repro_torch.launch import dryrun

CFG = configs.reduced(configs.get("llama3.2-3b")).replace(n_layers=2)
SERVE_CFG = CFG.replace(param_dtype="bfloat16")
TRAIN = ShapeConfig("train_ranks", "train", 16, 2)
PREFILL = ShapeConfig("prefill_ranks", "prefill", 16, 2)
LAYOUTS = {"tp": ParallelConfig(remat="full", fsdp_params=False),
           "tp_sp": ParallelConfig(remat="full", fsdp_params=False, sequence_parallel=True)}


def _ranks(device, tokens):
    """One rank: each layout's train step, then the prefill; the bytes
    staged around each."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import make_cell_ctx
    from repro_torch.models import transformer as T
    from repro_torch.parallel import steps as S
    from repro_torch.parallel.sharding import shard_cache, shard_params
    mesh = make_local_mesh(2)
    toks = torch.from_numpy(tokens)
    out = {"coords": mesh.coords}
    for name, pcfg in LAYOUTS.items():
        ctx = make_cell_ctx(mesh, pcfg, TRAIN.global_batch)
        state = S.init_train_state(torch.Generator().manual_seed(0), CFG, pcfg, ctx)
        step = S.make_train_step(CFG, pcfg, TrainConfig(), ctx)
        before = mesh.staged_bytes
        step(state, {"tokens": S.local_rows(toks, ctx)})
        out[name] = mesh.staged_bytes - before
    ctx = make_cell_ctx(mesh, LAYOUTS["tp"], PREFILL.global_batch)
    params = shard_params(T.init(SERVE_CFG, torch.Generator().manual_seed(0)), SERVE_CFG, ctx)
    cache = shard_cache(T.init_cache(SERVE_CFG, PREFILL.global_batch, PREFILL.seq_len,
                                     device="cpu"),
                        SERVE_CFG, ctx)
    before = mesh.staged_bytes
    S.make_prefill_step(SERVE_CFG, ctx)(params, {"tokens": toks}, cache)
    out["prefill"] = mesh.staged_bytes - before
    return out


@pytest.fixture(scope="module")
def ranks():
    tokens = np.random.RandomState(3).randint(0, CFG.vocab, (2, 16)).astype(np.int64)
    return launch(2, _ranks, tokens, device="cpu", timeout=300)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", ["tp", "tp_sp", "prefill"])
def test_recorded_staging_equals_process_mesh(ranks, rank, name):
    got = ranks[rank]
    coords = tuple(int(c) for c in got["coords"])
    mesh = RecordingMesh((1, 2), ("data", "model"), coords)
    if name == "prefill":
        raw = dryrun.trace_cell("llama3.2-3b", PREFILL, mesh, pcfg=LAYOUTS["tp"],
                                cfg_override=SERVE_CFG)
    else:
        raw = dryrun.trace_cell("llama3.2-3b", TRAIN, mesh, pcfg=LAYOUTS[name],
                                cfg_override=CFG)
    assert raw["staged_bytes"] > 0
    assert raw["staged_bytes"] == int(got[name]), (name, rank, raw["staged_bytes"], got[name])
