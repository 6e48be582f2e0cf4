"""The dry run's parts on the CPU: the recording mesh, the flash kernel's
meta rule, the MoE routing on ``meta`` and the dry-run CLI.

* The recording mesh's wire bytes for each collective, at several result
  sizes m and group sizes p, equal the JAX package's
  ``hlo_analysis.collective_stats`` on a one-line HLO text of that op,
  exactly (the same ring formulas); each collective returns an empty
  ``meta`` tensor of the real one's shape; a one-rank group is not tallied
  and stages nothing.
* The flash wrapper on ``meta`` returns the CUDA path's layout (a (B, Hq,
  Lq, D) view of a (B, Lq, Hq, D) tensor, q's dtype), tallies 4·D FLOPs a
  visible (query, key) pair and head -- the pairs counted here from the
  plain version's own mask -- and q, k, v and the output's bytes once, and
  never runs the plain version or moves a launch counter.  The other
  wrappers keep raising on ``meta``.
* ``moe._sizes`` and ``moe._kept`` on real tensors are ``bincount`` and
  ``nonzero``, as before; on ``meta`` the balanced split.
* ``python -m repro_torch.launch.dryrun --arch ... --shape ... --out``
  writes a record that ``roofline.table`` reads.
"""
import json
import weakref

import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import collective_stats
from repro_torch.core.mesh import Pending, RecordingMesh
from repro_torch.kernels import _meta
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import dryrun, roofline
from repro_torch.models import moe

HLO_OP = {"all-reduce": "all-reduce", "all-gather": "all-gather",
          "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
          "collective-permute": "collective-permute"}


def _hlo_line(kind: str, elems: int, p: int, n_devices: int) -> str:
    groups = (f"source_target_pairs={{{{0,1}},{{1,0}}}}" if kind == "collective-permute"
              else f"replica_groups=[{n_devices // p},{p}]<=[{n_devices}]")
    return (f"  %op.1 = f32[{elems}]{{0}} {HLO_OP[kind]}(f32[{elems}]{{0}} %x), "
            f"{groups}, channel_id=1")


def _call(mesh: RecordingMesh, kind: str, elems: int, p: int) -> torch.Tensor:
    """One collective over ``model`` (size p) whose result is f32[elems]."""
    f32 = dict(dtype=torch.float32, device="meta")
    if kind == "all-reduce":
        return mesh.all_reduce(torch.empty(elems, **f32), "sum", "model")
    if kind == "all-gather":
        return mesh.all_gather(torch.empty(elems // p, **f32), "model")
    if kind == "reduce-scatter":
        return mesh.reduce_scatter_sum(torch.empty(elems * p, **f32), "model")
    if kind == "all-to-all":
        return mesh.all_to_all(torch.empty(elems, **f32), "model")
    return mesh.permute(torch.empty(elems, **f32), [(i, (i + 1) % p) for i in range(p)], "model")


@pytest.mark.parametrize("kind", list(HLO_OP))
@pytest.mark.parametrize("elems,p", [(1024, 2), (4096, 4), (49152, 16), (3 * 2 ** 20, 8)])
def test_wire_bytes_equal_hlo_analysis(kind, elems, p):
    mesh = RecordingMesh((256 // p, p), ("data", "model"))
    out = _call(mesh, kind, elems, p)
    assert out.device.type == "meta" and out.numel() == elems
    want = collective_stats(_hlo_line(kind, elems, p, 256), 256)
    got = mesh.collective_stats()
    for k in HLO_OP:
        assert got["per_op"][k] == want["per_op"][k], (k, got["per_op"][k], want["per_op"][k])
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["result_bytes"] == want["result_bytes"]
    assert got["by_group"] == {f"{kind}@{p}": want["per_op"][kind]}


def test_recording_mesh_shapes_staging_and_one_rank_groups():
    mesh = RecordingMesh((2, 4), ("data", "model"))
    assert mesh.coords == (1, 3) and mesh.rank == 7 and mesh.index("model") == 3
    assert mesh.index(("data", "model")) == 7
    x = torch.empty((8, 3), dtype=torch.bfloat16, device="meta")
    n = x.numel() * 2
    with mesh:
        assert mesh.all_gather(x, "model").shape == (4, 8, 3)
        assert mesh.reduce_scatter_sum(x, "model").shape == (2, 3)
        assert mesh.all_to_all(x, ("data", "model")).shape == (8, 3)
        assert mesh.broadcast(x, 0, "data").shape == (8, 3)
        assert mesh.all_reduce(x, "max", "data").dtype == torch.bfloat16
    assert mesh.staged_bytes == 5 * n + (n + n // 4) + 2 * n + n + 2 * n
    assert mesh.collective_stats()["per_op"]["broadcast"] == {
        "count": 1, "result_bytes": n, "wire_bytes": float(n)}
    # a permute stages what this rank sends and what it receives
    before = mesh.staged_bytes
    pend = mesh.permute(x, [(3, 0)], "model", async_op=True)    # rank 3 sends only
    assert isinstance(pend, Pending) and mesh.staged_bytes == before + n
    assert pend.wait().shape == (8, 3) and mesh.staged_bytes == before + n
    mesh.permute(x, [(0, 3)], "model")                           # receives only
    assert mesh.staged_bytes == before + 2 * n
    mesh.permute(x, [(3, 3)], "model")                           # the pair (r, r)
    assert mesh.staged_bytes == before + 2 * n
    # one-rank groups: ProcessMesh's results, nothing tallied or staged
    one = RecordingMesh((1, 1), ("data", "model"))
    y = torch.empty(5)
    assert one.all_reduce(y, "sum", "model") is y and one.all_gather(y, "data").shape == (1, 5)
    assert one.reduce_scatter_sum(y, "model") is y and one.all_to_all(y, "model") is y
    assert torch.equal(one.permute(torch.ones(3), [(0, 0)], "model"), torch.ones(3))
    assert torch.equal(one.permute(torch.ones(3), [], "model"), torch.zeros(3))
    assert one.staged_bytes == 0 and one.tally == {}
    with pytest.raises(ValueError):
        mesh.permute(x, [(0, 1), (2, 1)], "model")
    with pytest.raises(ValueError):
        RecordingMesh((2, 2), ("data", "model"), coords=(2, 0))


def _mask_pairs(lq, lk, causal, window) -> int:
    """The plain version's own mask, summed."""
    qpos = np.arange(lq)[:, None] + (lk - lq)
    kpos = np.arange(lk)[None, :]
    mask = np.ones((lq, lk), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return int(mask.sum())


@pytest.mark.parametrize("causal,window", [(True, None), (True, 96), (False, None),
                                           (False, 50)])
@pytest.mark.parametrize("lq,lk", [(300, 300), (128, 512), (1, 700)])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.float32, 64)])
def test_flash_meta_rule(monkeypatch, causal, window, lq, lk, dtype, hd):
    def never(*a, **k):
        raise AssertionError("the plain version ran on meta")
    monkeypatch.setattr(fa, "flash_attention_ref", never)
    b, hq, hkv = 2, 12, 4
    q = torch.empty((b, lq, hq, hd), dtype=dtype, device="meta").transpose(1, 2)
    k = torch.empty((b, lk, hkv, hd), dtype=dtype, device="meta").transpose(1, 2)
    v = torch.empty((b, lk, hkv, hd), dtype=dtype, device="meta").transpose(1, 2)
    counts = (fa.launches, fa.launches_wgmma)
    with _meta.tallying() as tally:
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = torch.empty((b, lq, hq, hd), dtype=dtype).transpose(1, 2)
    assert out.device.type == "meta" and out.dtype == dtype
    assert out.shape == want.shape and out.stride() == want.stride()
    pairs = _mask_pairs(lq, lk, causal, window)
    assert fa.visible_pairs(lq, lk, causal, window) == pairs
    assert tally.flops == 4 * hd * b * hq * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    assert tally.bytes == size * hd * (2 * b * hq * lq + 2 * b * hkv * lk)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert tally.launches == {f"flash_attention_{route}": 1}
    assert (fa.launches, fa.launches_wgmma) == counts
    fa.flash_attention(q, k, v, causal=causal, window=window)     # no tally open: nothing


def test_other_wrappers_raise_on_meta():
    a = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError):
        mm.matmul(a, a)
    with pytest.raises(ValueError):
        mm.matmul_acc(a.clone(), a, a)
    q = torch.empty((2, 4, 64), dtype=torch.bfloat16, device="meta")
    pages = torch.empty((8, 16, 2, 64), dtype=torch.bfloat16, device="meta")
    tables = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    lengths = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pa.paged_attention(q, pages, pages, tables, lengths)


def test_moe_routing_real_unchanged_meta_balanced():
    rng = np.random.RandomState(0)
    for n in (1, 4, 7, 16):
        eid = torch.from_numpy(rng.randint(-2, n + 3, size=257))
        inside = eid[(eid >= 0) & (eid < n)]
        assert moe._sizes(eid, n) == torch.bincount(inside, minlength=n).tolist()
        mask = eid % 3 == 0
        assert torch.equal(moe._kept(mask, 5), torch.nonzero(mask).squeeze(1))
        got = moe._sizes(torch.empty(257, dtype=torch.int64, device="meta"), n)
        assert sum(got) == 257 and max(got) - min(got) <= 1 and len(got) == n
    kept = moe._kept(torch.empty(40, dtype=torch.bool, device="meta"), 24)
    assert kept.device.type == "meta" and kept.shape == (24,) and kept.dtype == torch.int64


def test_cli_writes_a_record_roofline_reads(tmp_path, capsys):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k", "--out", str(out),
                 "--no-probes"])
    assert "all 1 cells OK" in capsys.readouterr().out
    rec, = json.loads(out.read_text())
    for key in ("chips", "flops_per_device", "hlo_flops_global", "bytes_per_device",
                "collectives", "collectives_corrected", "memory", "scan_trips",
                "chunk_trips", "flops_moe_overcount_per_device", "model_flops",
                "useful_flops_ratio", "roofline", "compile_s", "probe_s", "batch_axes",
                "sharding_dropped", "rank", "routing", "staged_bytes"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["rank"] == 255 and rec["routing"] is None
    assert rec["collectives_corrected"] == rec["collectives"]
    assert rec["flops_moe_overcount_per_device"] == 0.0 and rec["probe_s"] == 0.0
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "peak_estimate_bytes"}
    assert rec["memory"]["alias_bytes"] == rec["memory"]["arguments"]["cache"]
    text = roofline.table(str(out))
    row = [line for line in text.splitlines() if line.startswith("| llama3.2-3b | decode_32k")]
    dom = rec["roofline"]["dominant"].replace("_s", "")
    assert len(row) == 1 and "ERROR" not in row[0] and f"| {dom} |" in row[0]
    roofline.main([str(out)])
    assert "| llama3.2-3b | decode_32k |" in capsys.readouterr().out


def test_alias_holds_the_arguments_storages_through_the_step(monkeypatch):
    """A step that drops argument tensors (a recurrent state written anew)
    frees no argument storage while the trace runs, so an output's storage
    can never take a freed one's id and count as an alias: only the cache
    the step hands back is."""
    freed = []

    def prepare(arch, shape, mesh, pcfg, cfg_override, tcfg):
        state = [torch.empty(1024, device="meta") for _ in range(8)]
        cache = torch.empty(16, device="meta")

        def step(state, cache):
            refs = [weakref.ref(t.untyped_storage()) for t in state]
            state.clear()
            freed.append(sum(r() is None for r in refs))
            return [torch.empty(1024, device="meta") for _ in range(8)], cache
        return None, None, None, step, (state, cache), {"state": state, "cache": cache}

    monkeypatch.setattr(dryrun, "prepare_cell", prepare)
    raw = dryrun.trace_cell("any", "any", dryrun.recording_mesh())
    assert freed == [0]
    assert raw["memory"]["alias_bytes"] == 16 * 4
