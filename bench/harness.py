"""One run of one cell: the model and traffic from the seed, the closed loop
through the port's scheduler, the window, the metrics and the check.

The window drives ``repro_torch.launch.scheduler.Scheduler.run`` with
greedy sampling, on the engine the mix names (paged or end-aligned).
Every request is submitted before ``run`` starts; ``records.Recorder``
stamps each streamed token, opens the window after the mix's
``warm_completions`` and ends the run at its close.  What comes before the
open (imports, the kernel build or its cache, the weights, the opening
burst of the loop) is set-up.  The steps are built through the logits tap
(``bench/tap.py``), which keeps the program's logits for the check.  After
the close the program's state is freed and the configuration's model
module judges a sample of the finished requests (``bench/check.py``).
"""
from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from bench import check, records, spec, traffic, weights
from bench.tap import Tap
from bench.trace import Trace

# modules the process that prints a result may not hold once the window
# has closed, compared by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Measured:
    """What a per-layer reader gets: the recorded run, the profiler's trace
    (None without ``--trace 1``), the configuration's ``model`` block and
    the traffic mix."""
    run: records.Run
    trace: Optional[Trace]
    model: dict
    mix: dict


def port_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model`` block."""
    from repro_torch.config import ModelConfig, MoEConfig
    kw = dict(model)
    moe = kw.pop("moe", None)
    kw["block_pattern"] = tuple(kw.get("block_pattern", ("attn",)))
    return ModelConfig(**kw, moe=MoEConfig(**moe) if moe else None)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    # a first start initialises CUPTI; do it in set-up, not in the window
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return profile(activities=[ProfilerActivity.CUDA])


def serve(model: dict, mix: dict, params, reqs, seconds: float, seed: int, *,
          prof=None, tap: Optional[Tap] = None):
    """The timed path: a closed loop of ``mix["clients"]`` users through
    ``Scheduler.run`` until the window closes, with its steps built through
    ``tap`` if one is given.  Returns (the recording, the requests
    accepted, refused requests, the device's peak bytes)."""
    from repro_torch.launch.scheduler import Request, Scheduler
    eng = mix["engine"]
    if mix["clients"] != eng["slots"]:
        raise ValueError(f"a closed loop of {mix['clients']} clients needs as many slots, "
                         f"not {eng['slots']}")
    kw = dict(slots=eng["slots"], max_len=eng["max_len"], paged=eng["paged"], seed=seed)
    if eng["paged"]:
        kw.update(block=eng["block"], chunk=eng["chunk"], pool_blocks=eng["pool_blocks"])
    else:
        kw.update(bucket=eng["bucket"])
    with tap.installed() if tap is not None else contextlib.nullcontext():
        sched = Scheduler(port_config(model), params, **kw)
    accepted, refused = [], 0
    for prompt, gen in reqs:
        try:
            sched.submit(Request(rid=len(accepted), prompt=prompt, gen=gen))
            accepted.append((prompt, gen))
        except ValueError:
            refused += 1
    rec = records.Recorder([g for _, g in accepted], mix["warm_completions"], seconds,
                           on_open=prof.start if prof is not None else None,
                           on_close=prof.stop if prof is not None else None)
    on_token = rec.on_token
    if tap is not None:
        tap.attach(sched, [len(p) for p, _ in accepted], [g for _, g in accepted],
                   check.ranks(seed, len(accepted)))

        def on_token(rid: int, tok: int) -> None:
            rec.on_token(rid, tok)
            tap.on_token(rid, tok, len(rec.tokens[rid]) - 1, rec.open is not None)
    try:
        sched.run(on_token=on_token)
    except records.WindowClosed:
        pass
    else:
        raise RuntimeError(f"the traffic's {len(accepted)} requests ran out before the "
                           f"window closed; the mix needs more")
    sched.reset()
    del sched
    if tap is not None:
        tap.detach()
    dev = params["embed"]["embedding"].device
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec, accepted, refused, peak


@dataclass
class Served:
    """A cell served from the seed: BENCHMARK.json, the configuration
    file, the mix, the model module, the weights, the prompts served, the
    recorded run, refused requests, the device's peak bytes and the tap."""
    bench: dict
    cfg: dict
    mix: dict
    module: object
    params: dict
    prompts: list
    run: records.Run
    refused: int
    peak: int
    tap: Optional[Tap]


def serve_cell(cell_name: str, seed: int, seconds: float, *, root: Path = spec.ROOT,
               device: str = "cuda", prof=None, tapped: bool = True) -> Served:
    """The cell's model, weights and traffic from the seed, then ``serve``
    (through the logits tap unless ``tapped`` is false)."""
    bench = spec.benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], root)
    model = cfg["model"]
    module = spec.model_module(cfg, root)
    dev = torch.device(device)
    params = weights.make(model, seed, dev, module.leaf_plan(model))
    reqs = traffic.generate(mix, model["vocab"], seed)
    eng, plan = mix["engine"], mix["check"]
    tap = Tap(slots=eng["slots"], rows=plan["tokens_each"], keep=plan["requests"] + 1,
              vocab=model["vocab"], device=dev) if tapped else None
    rec, accepted, refused, peak = serve(model, mix, params, reqs, seconds, seed, prof=prof,
                                         tap=tap)
    run = records.Run(rec, [len(p) for p, _ in accepted], eng["slots"],
                      eng["chunk"] if eng["paged"] else None)
    return Served(bench, cfg, mix, module, params, [p for p, _ in accepted], run, refused,
                  peak, tap)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = spec.ROOT, device: str = "cuda", t_start: float = None) -> tuple:
    """One run.  Returns (the result line's object, the lines of numbers
    compared for standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    prof = _profiler() if trace and dev.type == "cuda" else None
    sv = serve_cell(cell_name, seed, seconds, root=root, device=device, prof=prof)
    bench, cfg, mix, run = sv.bench, sv.cfg, sv.mix, sv.run
    model = cfg["model"]
    tr = Trace.from_profiler(prof, run.window_s) if prof is not None else None
    measured = Measured(run, tr, model, mix)

    if trace:
        metrics = {}
        for m in spec.metrics(bench, cell_name, "per_layer"):
            v = spec.reader(m["name"], root)(measured)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": v, "unit": m["unit"]}
                   for m in spec.metrics(bench, cell_name, "end_to_end")
                   if (v := end_to_end(m["name"], run, t_start)) is not None}

    cmp = check.compare(run, sv.params, model, sv.prompts, seed, mix["check"], dev,
                        logits=sv.module.logits, tap=sv.tap)
    numbers = check.numbers(cmp, cfg["check"], root)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(sv.peak)}
    result = {"correct": all(n["ok"] for n in numbers.values()),
              "attempted": int(len(run.attempted()) + sv.refused), "failed": int(sv.refused),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["card"] = power_limit() if dev.type == "cuda" else "cpu"
    result["kv_live_share"] = 100.0 * run.kv_live_tokens() / kv_capacity(mix["engine"])
    result["check"] = {k: {"value": n["value"], "limit": n["limit"], "rule": n["rule"]}
                       for k, n in numbers.items()}
    lines = [f"check {k}: {n['value']} (limit {n['rule']} {n['limit']}) "
             f"{'ok' if n['ok'] else 'FAILED'}" for k, n in numbers.items()]
    return result, lines


def kv_capacity(eng: dict) -> int:
    """The tokens the engine's cache holds: every slot's row to ``max_len``
    end-aligned, the page arena paged."""
    return eng["pool_blocks"] * eng["block"] if eng["paged"] else eng["slots"] * eng["max_len"]


def end_to_end(name: str, run: records.Run, t_start: float) -> Optional[float]:
    """The end-to-end metrics, all on the host's clock."""
    if name == "out_tok_s":
        return run.out_tokens() / run.window_s
    if name == "ttft_p95_ms":
        v = records.percentile(run.ttft_s(), 95)
        return None if v is None else v * 1e3
    if name == "itl_p95_ms":
        v = records.percentile(run.itl_s(), 95)
        return None if v is None else v * 1e3
    if name == "setup_s":
        return run.open - t_start
    raise KeyError(f"no end-to-end metric named {name!r}")
