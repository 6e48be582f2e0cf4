"""The port's ``launch/roofline.py`` against the JAX package's.

The port's tables read every constant from ``costmodel`` when they are
made (its own: H100 data-sheet figures).  Held to the reference, the
module reads a stand-in ``costmodel`` whose constants are the reference's
(its ICI link, peak, HBM rate and HBM size), as
``tests/test_torch_costmodel.py`` holds the cost model's functions: then
every number of every table equals the reference's, parsed and compared
cell for cell at 1e-12 relative, and the text around them is the same.
``kv_bytes_per_seq`` is equal for every arch; ``fraction_of_roofline``
and the record ``table`` match on records with the keys of JAX's dry-run
JSON, and ``recommend`` names the Hopper flash kernel and shared memory
where the reference names its Pallas kernel and VMEM.  ``plan_table``
does not print ``BENCH_train.json`` (JAX CPU-simulator numbers).
"""
import json
import re
import types

import pytest

from repro import configs as jconfigs
from repro.core import costmodel as rm
from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.core import costmodel as cm
from repro_torch.launch import roofline as roof

REL = 1e-12
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture
def reference_constants(monkeypatch):
    """``roofline`` reading the reference's constants."""
    ref = types.SimpleNamespace(**{k: getattr(cm, k) for k in dir(cm) if not k.startswith("__")})
    ref.NVLINK = cm.LinkClass(rm.ICI.t_s, rm.ICI.t_w)
    ref.PEAK_FLOPS_BF16, ref.HBM_BW, ref.HBM_PER_CHIP = (rm.PEAK_FLOPS_BF16, rm.HBM_BW,
                                                         rm.HBM_PER_CHIP)
    monkeypatch.setattr(roof, "costmodel", ref)


def _same_text(got: str, want: str) -> None:
    """Equal line for line, the numbers at 1e-12 relative, the rest exact."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        for a, b in zip(NUM.findall(g), NUM.findall(w)):
            assert float(a) == pytest.approx(float(b), rel=REL, abs=0.0), (g, w)


@pytest.mark.parametrize("n,p", [(8192, 64), (8192, 16), (4096, 8), (1000, 7), (6144, 512)])
def test_matmul_scenarios_table_equals_jax(reference_constants, n, p):
    _same_text(roof.matmul_scenarios_table(n, p), jroof.matmul_scenarios_table(n, p))
    _same_text(roof.matmul_scenarios_table(n, p, 4), jroof.matmul_scenarios_table(n, p, 4))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_kv_bytes_per_seq_equals_jax(arch):
    for seq in (1, 2048, 32768, 524288):
        assert roof.kv_bytes_per_seq(configs.get(arch), seq) == \
            jroof.kv_bytes_per_seq(jconfigs.get(arch), seq)


@pytest.mark.parametrize("arch,prompt,gen,chips", [("llama3.2-3b", 2048, 256, 16),
                                                   ("mixtral-8x22b", 512, 64, 1),
                                                   ("zamba2-1.2b", 4096, 128, 4),
                                                   ("whisper-base", 128, 32, 1)])
def test_serve_table_equals_jax(reference_constants, arch, prompt, gen, chips):
    _same_text(roof.serve_table(arch, prompt, gen, chips),
               jroof.serve_table(arch, prompt, gen, chips))


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "kimi-k2-1t-a32b"])
def test_plan_table_equals_jax_without_the_cpu_benchmark(reference_constants, arch, kind):
    got = roof.plan_table(arch, 256, 4096, (16, 16), kind)
    want = jroof.plan_table(arch, 256, 4096, (16, 16), kind)
    assert "BENCH_train.json" not in got
    n = len(got.splitlines())
    _same_text(got, "\n".join(want.splitlines()[:n]))
    assert all("BENCH_train.json" in line or "measured" in line or line.startswith("  ")
               or not line for line in want.splitlines()[n:])


def _records() -> list:
    """Dry-run records with the reference's keys: one of each dominant term
    and kind, a skipped cell and an errored one."""
    def rec(arch, shape, kind, dom, terms, flops, chips=256):
        t = dict(zip(("compute_s", "memory_s", "collective_s"), terms))
        return {"arch": arch, "shape": shape, "kind": kind, "chips": chips,
                "model_flops": flops, "useful_flops_ratio": 0.731,
                "roofline": dict(t, dominant=dom, bound_s=t[dom]),
                "collectives_corrected": {"wire_bytes": 3.0e11, "per_op": {
                    "all-reduce": {"result_bytes": 1e9, "wire_bytes": 2.0e11,
                                   "count_in_text": 4},
                    "all-gather": {"result_bytes": 5e8, "wire_bytes": 1.0e11,
                                   "count_in_text": 9}}}}
    return [rec("llama3.2-3b", "train_4k", "train", "collective_s", (0.8, 0.3, 1.7), 1.9e17),
            rec("llama3.2-3b", "decode_32k", "decode", "memory_s", (1e-3, 0.02, 4e-3), 8e11),
            rec("mixtral-8x22b", "prefill_32k", "prefill", "memory_s", (0.5, 0.9, 0.2), 4e16),
            rec("chameleon-34b", "train_4k", "train", "compute_s", (2.5, 1.0, 0.4), 2.2e18),
            {"arch": "llama3.2-3b", "shape": "long_500k", "skipped": True},
            {"arch": "xlstm-1.3b", "shape": "long_500k", "error": "x" * 90}]


def test_record_table_and_fraction_equal_jax(reference_constants, tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_records()))
    for r in _records():
        if "roofline" in r:
            assert roof.fraction_of_roofline(r) == pytest.approx(
                jroof.fraction_of_roofline(r), rel=REL, abs=0.0)
    got, want = roof.table(str(path)).splitlines(), jroof.table(str(path)).splitlines()
    assert len(got) == len(want) == 2 + len(_records())
    for g, w, r in zip(got[2:], want[2:], _records()):
        reworded = r.get("kind") == "prefill"          # memory-bound, not decode
        cut = (lambda line: line.rsplit("|", 2)[0]) if reworded else (lambda line: line)
        _same_text(cut(g), cut(w))


def test_recommend_names_the_hopper_kernel():
    for r in _records()[:4]:
        got, want = roof.recommend(r), jroof.recommend(r)
        if r["kind"] == "prefill":
            assert "Hopper flash kernel" in got and "shared memory" in got
            assert "VMEM" not in got and "Pallas" not in got
        else:
            assert got == want


def test_cli(capsys, tmp_path):
    roof.main(["--matmul", "n=4096,p=8"])
    assert "DNS (3D)" in capsys.readouterr().out
    roof.main(["--serve", "arch=llama3.2-3b,prompt=128,gen=16,chips=1"])
    assert "tok/s" in capsys.readouterr().out
    roof.main(["--plan", "arch=llama3.2-3b,batch=16,seq=512,mesh=2x2"])
    out = capsys.readouterr().out
    assert "plan lattice" in out and "BENCH_train.json" not in out
    path = tmp_path / "r.json"
    path.write_text(json.dumps(_records()))
    roof.main([str(path)])
    assert "roofline-frac" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        roof.main(["--matmul", "n=x"])
