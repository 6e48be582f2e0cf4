"""A checkout-shaped directory with tiny cells, for the CPU tests: the
benchmark's own metric readers and check statistics beside a dense and an
MoE model of a few thousand parameters and short mixes on both engines."""
from __future__ import annotations

import functools
import inspect
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab": 256, "block_pattern": ["attn"],
         "rope_fraction": 0.5, "norm_eps": 1e-5, "dtype": "bfloat16"}
MOE = {"name": "tinymoe", "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
       "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab": 256,
       "block_pattern": ["attn_moe"], "rope_theta": 1e6, "window": 128, "norm_eps": 1e-5,
       "dtype": "bfloat16", "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 64}}
# the tiny models' limits: the dense model's widest gap reads 0.00-0.03 in
# sound CPU runs and 0.3-0.6 in the float8 control.  The MoE model's widest
# gap swings up to 2 on routing flips in the served precision, so it is
# judged by the logits tap alone: the 75th percentile of the logit error
# reads 0.012-0.015 sound and 0.20-0.29 in the control (the dense model's
# 0.011-0.012 and 0.15-0.17), 0.8-1.4 under a state or batch fault.  A
# served token that is not the argmax of the program's own logits is
# counted exactly, limit 0
SLOTS = 32
LIMITS = {"tiny": {"max_logit_gap": 0.15, "served_not_argmax": 0},
          "tinymoe": {"served_not_argmax": 0, "logit_err_p75": 0.05}}


def mix(paged: bool) -> dict:
    """A closed loop of 32 clients, as many as a real cell's sample has
    requests, so that a fault in some rows meets the check as it would
    there."""
    eng = ({"paged": True, "slots": SLOTS, "block": 8, "chunk": 16, "max_len": 128,
            "pool_blocks": SLOTS * 16} if paged else
           {"paged": False, "slots": SLOTS, "max_len": 128, "bucket": 16})
    return {"name": "tiny-paged" if paged else "tiny-aligned", "loop": "closed",
            "clients": SLOTS, "requests": 1200,
            "prompt": {"dist": "lognormal", "median": 20, "sigma": 1.0, "min": 4, "max": 80},
            "output": {"dist": "lognormal", "median": 8, "sigma": 0.8, "min": 2, "max": 40},
            "engine": eng, "warm_completions": 8, "check": {"requests": 32, "tokens_each": 32}}


def make_root(tmp: Path) -> Path:
    """A directory holding BENCHMARK.json, the tiny configurations and mixes
    and a copy of ``bench/metrics``; returns it."""
    root = Path(tmp)
    (root / "bench" / "configs").mkdir(parents=True)
    (root / "bench" / "traffic").mkdir(parents=True)
    for part in ("metrics", "checks"):
        shutil.copytree(REPO / "bench" / part, root / "bench" / part)
    for model in (DENSE, MOE):
        cfg = {"name": model["name"], "source": "test", "model": model,
               "check": LIMITS[model["name"]]}
        (root / "bench" / "configs" / f"{model['name']}.json").write_text(json.dumps(cfg))
    for paged in (True, False):
        m = mix(paged)
        (root / "bench" / "traffic" / f"{m['name']}.json").write_text(json.dumps(m))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = {
        "configs": [{"name": m["name"], "file": f"bench/configs/{m['name']}.json"}
                    for m in (DENSE, MOE)],
        "workloads": [{"name": "t.paged", "config": "tiny", "traffic": "tiny-paged", "chips": 1},
                      {"name": "t.aligned", "config": "tiny", "traffic": "tiny-aligned",
                       "chips": 1},
                      {"name": "m.aligned", "config": "tinymoe", "traffic": "tiny-aligned",
                       "chips": 1}],
        "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                       for m in real["end_to_end"]],
        "per_layer": [{k: v for k, v in m.items() if k != "workloads"}
                      for m in real["per_layer"]],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def model_module(root: Path, name: str, edits=()) -> str:
    """Write ``bench/models/<name>.py`` under ``root``: a copy of
    ``bench/reference.py`` with ``weights.leaf_plan`` beside it, each
    (old, new) of ``edits`` replaced once.  Returns the path a
    configuration file names."""
    from bench import weights
    text = "\n\n".join([(REPO / "bench" / "reference.py").read_text(),
                         inspect.getsource(weights.kind_of), inspect.getsource(weights.leaf_plan)])
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    rel = f"bench/models/{name}.py"
    (root / "bench" / "models").mkdir(parents=True, exist_ok=True)
    (root / rel).write_text(text)
    return rel


def token_clock(monkeypatch, dt: float = 1e-3) -> None:
    """Make the recorder's clock advance ``dt`` a reading, so that a window
    holds a fixed number of tokens however busy the machine is."""
    from bench import records
    t = [0.0]

    def clock():
        t[0] += dt
        return t[0]

    monkeypatch.setattr(records, "Recorder", functools.partial(records.Recorder, clock=clock))


def one_thread():
    """A fixture's body: torch on one CPU thread while a module's tests run
    (the test runner keeps several workers on the machine's cores), the
    previous count restored after."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
