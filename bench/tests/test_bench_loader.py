"""The benchmark is data: a new configuration, traffic mix, per-layer
metric, model module and check statistic are new files and new entries,
found by name, with no edit to a file that is there; and
``BENCHMARK.json`` holds what each cell needs."""
import hashlib
import json
import math
import re

import pytest

import bench_tiny
from bench import harness, spec, traffic

REPO = bench_tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path, monkeypatch):
    bench_tiny.token_clock(monkeypatch)
    root = bench_tiny.make_root(tmp_path)
    before = _digests(root / "bench")
    cfg = {"name": "tiny2", "source": "test", "model": dict(bench_tiny.DENSE, n_layers=1),
           "check": {"max_logit_gap": 0.15}}
    (root / "bench" / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    mix = dict(bench_tiny.mix(False), name="tiny-short")
    mix["output"] = dict(mix["output"], max=6)
    (root / "bench" / "traffic" / "tiny-short.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "tokens_in_window.py").write_text(
        "def read(m):\n    return float(m.run.out_tokens())\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "file": "bench/configs/tiny2.json"})
    bench["workloads"].append({"name": "t2.short", "config": "tiny2",
                               "traffic": "tiny-short", "chips": 1})
    bench["per_layer"].append({"name": "tokens_in_window", "unit": "tokens",
                               "workloads": ["t2.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res, lines = harness.run_cell("t2.short", 99, 0.6, True, root=root, device="cpu")
    assert res["correct"], lines
    assert res["metrics"]["tokens_in_window"]["value"] > 0
    # the old cells do not report the new metric, and no file changed
    assert "tokens_in_window" not in [m["name"] for m in spec.metrics(bench, "t.paged",
                                                                       "per_layer")]
    after = _digests(root / "bench")
    assert {p: d for p, d in after.items() if p in before} == before


# the copy's weights: the embedding drawn at std 0.05 (the plan's 0.02)
WIDER_EMBEDDING = ('(("embed", "embedding"), (vocab, d), "matrix", 0.02)',
                   '(("embed", "embedding"), (vocab, d), "matrix", 0.05)')


def _add_cell(root, name, model, check, reference):
    cfg = {"name": name, "source": "test", "model": model, "check": check,
           "reference": reference}
    (root / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "file": f"bench/configs/{name}.json"})
    bench["workloads"].append({"name": f"{name}.aligned", "config": name,
                               "traffic": "tiny-aligned", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return f"{name}.aligned"


def test_a_new_reference_and_statistic_need_no_edit(tmp_path, monkeypatch):
    """A configuration naming its own model module (a copy of the
    reference whose ``leaf_plan`` draws the embedding wider) and its own
    statistic runs correct, with the weights that copy plans."""
    bench_tiny.token_clock(monkeypatch)
    root = bench_tiny.make_root(tmp_path)
    before = _digests(root / "bench")
    ref = bench_tiny.model_module(root, "tinywide", [WIDER_EMBEDDING])
    (root / "bench" / "checks" / "tapped_share.py").write_text(
        "def read(cmp):\n    return cmp['err'].size / max(cmp['gaps'].size, 1)\n")
    cell = _add_cell(root, "tinywide", bench_tiny.MOE,
                     {"served_not_argmax": 0, "logit_err_p75": 0.05, "tapped_share": 1.0},
                     ref)
    res, lines = harness.run_cell(cell, 41, 0.6, False, root=root, device="cpu")
    assert res["correct"], lines
    assert 0.5 <= res["check"]["tapped_share"]["value"] <= 1.0
    sv = harness.serve_cell(cell, 41, 0.6, root=root, device="cpu")
    assert sv.module.leaf_plan(bench_tiny.MOE)[0][3] == 0.05
    assert 0.045 < sv.params["embed"]["embedding"].float().std() < 0.055
    after = _digests(root / "bench")
    assert {p: d for p, d in after.items() if p in before} == before


def test_the_module_a_configuration_names_judges_it(tmp_path, monkeypatch):
    """A copy of the reference with one deliberate change, its RoPE base
    doubled, judges the cell that names it: the run is not correct."""
    bench_tiny.token_clock(monkeypatch)
    root = bench_tiny.make_root(tmp_path)
    ref = bench_tiny.model_module(root, "tinyrope", [
        ('model.get("rope_theta", 10000.0) ** (', '(2 * model.get("rope_theta", 10000.0)) ** (')])
    cell = _add_cell(root, "tinyrope", bench_tiny.DENSE, bench_tiny.LIMITS["tiny"], ref)
    res, lines = harness.run_cell(cell, 42, 0.6, False, root=root, device="cpu")
    assert not res["correct"], lines
    assert res["check"]["max_logit_gap"]["value"] > 0.15
    assert res["check"]["served_not_argmax"]["value"] == 0


def test_benchmark_json_holds_what_each_cell_needs():
    bench = spec.benchmark(REPO)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"out_tok_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"} <= e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and (REPO / "bench" / "metrics" / f"{m['name']}.py").exists()
    for c in bench["workloads"]:
        assert c["chips"] == 1 and len(c["why"]) <= 200
        cfg = spec.config(bench, c["config"], REPO)
        mix = spec.traffic(c["traffic"], REPO)
        eng = mix["engine"]
        assert mix["clients"] == eng["slots"]
        reqs = traffic.generate(mix, cfg["model"]["vocab"], 2 ** 31 + 3)
        longest = max(len(p) + g for p, g in reqs)
        assert longest <= eng["max_len"]
        if eng["paged"]:
            # admission never waits for pages: every slot can hold max_len
            assert eng["pool_blocks"] >= eng["slots"] * math.ceil(eng["max_len"] / eng["block"])
        assert spec.metrics(bench, c["name"], "per_layer")
        for name, lim in cfg["check"].items():
            assert (REPO / "bench" / "checks" / f"{name}.py").exists()
            assert lim is not None and lim >= 0
        if "reference" in cfg:
            assert (REPO / cfg["reference"]).exists() and cfg["reference"].startswith("bench/")
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists() and c["file"].startswith("bench/")


def test_every_seed_offers_the_same_lengths():
    mix = spec.traffic("conv-aligned", REPO)
    a = traffic.generate(mix, 65024, 1)
    b = traffic.generate(mix, 65024, 2 ** 31 + 7)
    la, lb = [(len(p), g) for p, g in a], [(len(p), g) for p, g in b]
    # one sequence of lengths, entered at another offset
    k = traffic.STRATUM
    assert la != lb and any(la[d:] == lb[:len(lb) - d] or lb[d:] == la[:len(la) - d]
                            for d in range(k))
    # every stratum holds the distribution's quantiles
    q = sorted(traffic.quantile_lengths(mix["prompt"], k).tolist())
    fixed = [len(p) for p, _ in traffic.generate(dict(mix, requests=4 * k), 65024, 0)]
    off = next(d for d in range(k) if sorted(fixed[k - d:2 * k - d]) == q)
    assert all(sorted(fixed[lo:lo + k]) == q for lo in range(k - off, 3 * k, k))
    c = traffic.generate(mix, 65024, 1)
    assert all((p == q).all() and g == h for (p, g), (q, h) in zip(a, c))
