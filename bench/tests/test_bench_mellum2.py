"""Mellum2-12B-A2.5B in the benchmark: the loader finds its configuration,
its model module and its cell; the module's weight plan is the benchmark's;
its reference matches the port's forward in float32 at a reduced width
(and its float8 control does not); and a tiny cell of the same layers runs
through the harness on the CPU, correct, with the new per-layer metrics
reading nothing where the CPU has no device trace."""
import json
import shutil

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bench_tiny
from bench import harness, spec, weights

REPO = bench_tiny.REPO
CELL = "mellum2.code.aligned"
NEW = ("idle_moe_share", "moe_experts_roofline", "mixed_paged_roofline",
       "mixed_flash_roofline")
# a reduced width of the same layers: the real period, window 16, YaRN over
# 32 original positions, 8 experts top-2
TINY = {"name": "tinymellum", "family": "moe", "n_layers": 4, "d_model": 64, "n_heads": 8,
        "n_kv_heads": 2, "head_dim": 32, "d_ff": 128, "vocab": 256,
        "block_pattern": ["attn_moe"], "rope_theta": 1000.0, "window": None,
        "layer_windows": [16, 16, 16, None],
        "yarn": {"factor": 16.0, "original_max_position_embeddings": 32, "beta_fast": 32.0,
                 "beta_slow": 1.0, "attention_factor": 1.2772588722239782},
        "norm_eps": 1e-6, "dtype": "bfloat16",
        "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


def _module():
    bench = spec.benchmark(REPO)
    return spec.model_module(spec.config(bench, "mellum2-12b-a2.5b", REPO), REPO)


def test_the_loader_finds_the_configuration_module_and_cell():
    bench = spec.benchmark(REPO)
    cell = spec.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("mellum2-12b-a2.5b",
                                                                "code-aligned", 1)
    cfg = spec.config(bench, cell["config"], REPO)
    assert cfg["reference"] == "bench/models/mellum2.py" and cfg["reduced"] == {}
    model = cfg["model"]
    # the published widths, nothing cut
    assert (model["n_layers"], model["d_model"], model["n_heads"], model["n_kv_heads"],
            model["head_dim"], model["vocab"]) == (cfg["num_hidden_layers"], cfg["hidden_size"],
                                                   cfg["num_attention_heads"],
                                                   cfg["num_key_value_heads"], cfg["head_dim"],
                                                   cfg["vocab_size"])
    assert (model["moe"]["n_experts"], model["moe"]["top_k"], model["moe"]["d_ff_expert"]) == \
        (cfg["num_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"])
    windows = [model["layer_windows"][i % 4] for i in range(model["n_layers"])]
    assert windows == [cfg["sliding_window"] if t == "sliding_attention" else None
                       for t in cfg["layer_types"]]
    full = cfg["rope_parameters"]["full_attention"]
    assert model["yarn"] == {k: full[k] for k in model["yarn"]}
    assert model["rope_theta"] == full["rope_theta"] == \
        cfg["rope_parameters"]["sliding_attention"]["rope_theta"]
    port = harness.port_config(model)
    assert port.layer_windows == (1024, 1024, 1024, None) and hash(port)
    assert spec.traffic(cell["traffic"], REPO)["engine"]["max_len"] > 1024
    names = [m["name"] for m in spec.metrics(bench, CELL, "per_layer")]
    assert set(NEW) <= set(names)
    assert not {"serve_mfu", "flash_attn_roofline", "paged_attn_roofline"} & set(names)
    for name in NEW:
        assert [m for m in bench["per_layer"] if m["name"] == name][0]["workloads"] == [CELL]


def test_the_modules_weight_plan_is_the_benchmarks():
    mod = _module()
    model = spec.config(spec.benchmark(REPO), "mellum2-12b-a2.5b", REPO)["model"]
    assert mod.leaf_plan(model) == weights.leaf_plan(model)
    n = sum(torch.Size(shape).numel() for _, shape, kind, _ in mod.leaf_plan(model)
            if kind == "matrix")
    assert 12.1e9 < n < 12.2e9          # 24.3 GB in bf16


def test_reference_matches_the_ports_forward():
    from repro_torch.models import transformer as T
    mod = _module()
    model = dict(TINY, dtype="float32")
    params = weights.make(model, 2 ** 33 + 24, torch.device("cpu"), mod.leaf_plan(model))
    cfg = harness.port_config(model)
    tokens = torch.randint(0, 256, (1, 90), generator=torch.Generator().manual_seed(4))
    want = T.forward(params, tokens, cfg)[0, -40:]
    got = mod.logits(params, model, tokens[0], 40)
    scale = want.abs().max()
    assert (got - want).abs().max() / scale < 1e-4
    low = mod.logits(params, model, tokens[0], 40, fp8=True)
    assert (low - want).abs().max() / scale > 1e-2
    # the window and YaRN matter at these positions
    for other in (dict(model, layer_windows=[None] * 4), dict(model, yarn=None)):
        assert (mod.logits(params, other, tokens[0], 40) - want).abs().max() / scale > 1e-2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = bench_tiny.make_root(tmp_path_factory.mktemp("tiny"))
    (root / "bench" / "models").mkdir()
    shutil.copy(REPO / "bench" / "models" / "mellum2.py", root / "bench" / "models")
    cfg = {"name": "tinymellum", "source": "test", "model": TINY,
           "reference": "bench/models/mellum2.py", "check": bench_tiny.LIMITS["tinymoe"]}
    (root / "bench" / "configs" / "tinymellum.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinymellum", "file": "bench/configs/tinymellum.json"})
    bench["workloads"].append({"name": "mel.aligned", "config": "tinymellum",
                               "traffic": "tiny-aligned", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_tiny_cell_of_its_layers_runs_correct(root, monkeypatch):
    bench_tiny.token_clock(monkeypatch)
    res, lines = harness.run_cell("mel.aligned", 2 ** 31 + 24, 0.6, False, root=root,
                                  device="cpu")
    assert res["correct"], lines
    assert res["check"]["served_not_argmax"]["value"] == 0
    # the mix's prompts reach 80 tokens, past the window of 16
    assert res["metrics"]["out_tok_s"]["value"] > 0


def test_a_profiled_tiny_run_has_the_moe_spans_and_no_device_metric(root):
    with profile(activities=[ProfilerActivity.CPU]):     # a first start is slow
        pass
    prof = profile(activities=[ProfilerActivity.CPU])
    sv = harness.serve_cell("mel.aligned", 2 ** 31 + 25, 1.0, root=root, device="cpu", prof=prof)
    from bench import spans
    from bench.trace import Trace
    m = harness.Measured(sv.run, Trace.from_profiler(prof, sv.run.window_s), sv.cfg["model"],
                         sv.mix)
    sp = spans.read(m)
    # the whole recording: a layer that straddles the window's close keeps
    # its moe.experts span inside the window and its moe.ffn span outside
    ffn = [s.attrs["rows"] for s in sp.rec.spans if s.name == "moe.ffn"]
    experts = [s.attrs["rows"] for s in sp.rec.spans if s.name == "moe.experts"]
    assert len(ffn) == len(experts) > 0 and sum(experts) == 2 * sum(ffn)
    assert sp.of("moe.experts").any()
    # no CUDA operation on the CPU: the device readers read nothing
    assert all(spec.reader(n, root)(m) is None for n in NEW)
