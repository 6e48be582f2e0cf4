"""Multi-pod dry run: the port of the JAX package's ``launch/dryrun.py``.

Every (architecture x input shape) cell on the production meshes, (16, 16)
or (2, 16, 16), without a card and without processes: one rank's program
runs on ``meta`` tensors (shapes and dtypes, no storage), as JAX's dry run
compiles the SPMD program for fake host devices.  The rank sits on a
``core.mesh.RecordingMesh`` (by default at the last coordinate of every
axis: its end-aligned prefill rows see the most keys), whose collectives
return empty ``meta`` blocks and tally each call's result and wire bytes
and what ``ProcessMesh`` would stage through the host.  The rank's blocks
of the train state or of the parameters and the cache are cut by the
cell's specs (``local_block``; the cache blocks tagged by ``keep_spec``).
The step runs under:

  * ``torch.utils.flop_counter.FlopCounterMode``, plus the FLOPs that the
    kernels' meta rules tally (``kernels/_meta.py``: the flash kernel in
    every fused prefill);
  * a dispatch mode that sums every op's operand and result bytes (views
    and allocations excluded), plus the kernels' tallied bytes.  This is
    the eager program's traffic, op by op; XLA's "bytes accessed" counts
    its fused program instead, so the two are not the same measure;
  * a dispatch mode that tracks the storages the step allocates, by weak
    reference, and records the most bytes alive at once (``temp_bytes``;
    ``peak_estimate_bytes`` adds the arguments).

The decode step takes the cell's ``meta`` position, which has no value:
the attention layer clamps it as a tensor where it reads a real one on
the host (``models/layers.py``), so the token's write is one row
scatter, as on the card.  An MoE
layer routes on ``meta`` by the balanced split (``models/moe.py``:
``_sizes``, ``_kept``): the record says ``"routing": "balanced"``.

The record has the keys of JAX's, so ``launch/roofline.py``'s ``table``,
``recommend`` and ``fraction_of_roofline`` read it unchanged.  JAX fields
with no counterpart here:

  * the scan-probe correction (``run_cell``'s unroll-1/2 probes and the
    solve for the true trip counts): the port unrolls every layer and
    chunk loop, so each is counted as it runs; ``collectives_corrected``
    equals ``collectives``, ``probe_s`` is 0, and ``scan_trips`` /
    ``chunk_trips`` are information only;
  * ``_moe_ragged_overcount``: the grouped expert products are counted as
    they run, one product an expert, so nothing is over-counted and
    ``flops_moe_overcount_per_device`` is 0.

The roofline terms are the cost model's predictions on H100 data-sheet
constants (``core/costmodel.py``), not measurements.

Usage (CPU only; ``--no-probes`` is accepted and changes nothing):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out results.json
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
import traceback
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import configs
from repro_torch.config import SHAPES, ParallelConfig, TrainConfig
from repro_torch.core import costmodel
from repro_torch.core.mesh import AbstractMesh, RecordingMesh, local_block
from repro_torch.kernels import _meta
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.specs import Cell, build_cell, keep_spec
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.parallel import planner, sharding
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import param_specs
from repro_torch.tree import tree_map

Tree = Any


def default_pcfg(arch: str, kind: str, multi_pod: bool = False) -> ParallelConfig:
    """The cost model's choice for a cell: ``planner.default_plan`` ranks
    the plan lattice of the (16, 16) mesh, or of (2, 16, 16) with
    ``multi_pod``, and this returns the winner's config."""
    return planner.default_plan(arch, kind, multi_pod=multi_pod).to_pcfg()


def _cell_cfg(arch: str, kind: str):
    """Model config for a cell: serving runs bf16 params (inference norm)."""
    cfg = configs.get(arch)
    if kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")
    return cfg


HILLCLIMB_OVERRIDES = {"pcfg": {}, "cfg": {}}  # set by --hc-* CLI flags


def _apply_overrides(pcfg, cfg):
    if HILLCLIMB_OVERRIDES["pcfg"]:
        pcfg = dataclasses.replace(pcfg, **HILLCLIMB_OVERRIDES["pcfg"])
    for k, v in HILLCLIMB_OVERRIDES["cfg"].items():
        if k == "mm_bf16":
            if cfg.ssm is not None:
                cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, mm_bf16=v))
            if cfg.xlstm is not None:
                cfg = cfg.replace(xlstm=dataclasses.replace(cfg.xlstm, mm_bf16=v))
        else:
            cfg = cfg.replace(**{k: v})
    return pcfg, cfg


# ---------------------------------------------------------------------------
# what the step does: bytes op by op, and the storages it keeps alive
# ---------------------------------------------------------------------------
_ALLOCS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
           torch.ops.aten.empty_like.default}


def _flat(x, out: list) -> list:
    """The tensors in ``x`` (nested tuples, lists and dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


def _tensors(tree) -> list:
    return _flat(tree, [])


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _key(x):
    """A hashable description of an op argument, tensors by layout."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _key(v)) for k, v in sorted(x.items()))
    return (type(x).__name__, x)


class _Counting(TorchDispatchMode):
    """What the step does below autograd, op by op:

      * ``bytes``: each op's tensor operand and result bytes summed; views
        and allocations move nothing and are skipped;
      * ``peak``: the most bytes alive at once in storages the step
        allocates.  A storage an op reads that the mode has not seen existed
        before the step (an argument) and is not counted; a new one an op
        returns is counted until it is freed (a weak-reference finaliser);
      * output layouts memoised: many of PyTorch's meta rules are Python
        reference implementations (a few hundred microseconds a call), and
        the port's loops (the sLSTM's per-token steps, the chunk scans, one
        product an expert) call one op on the same layouts many times.  An
        op on ``meta`` tensors that is not a view, mutates nothing and
        returns fresh tensors gets, after its first call, empty tensors of
        the layouts that call returned."""

    def __init__(self):
        super().__init__()
        self.bytes = self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._memo = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def _call(self, func, args, kwargs, ins):
        schema = func._schema
        if func.is_view or schema.is_mutable or not ins or \
                any(r.alias_info is not None for r in schema.returns) or \
                any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            hit = self._memo.get(key)
        except TypeError:                 # an unhashable argument
            return func(*args, **kwargs)
        if hit is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
                self._memo[key] = (type(out) if isinstance(out, (tuple, list)) else None,
                                   [(tuple(t.shape), t.stride(), t.dtype) for t in outs])
            return out
        kind, layouts = hit
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in layouts]
        return kind(outs) if kind is not None else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = 0
        out = self._call(func, args, kwargs, ins)
        outs = _tensors(out)
        if not func.is_view and func not in _ALLOCS:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                n = st.nbytes()
                self._seen[st] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, n)
        return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def _blocks(tree: Tree, specs: Tree, mesh, *, cache: bool = False) -> Tree:
    """The rank's block of every leaf (a ``meta`` tensor of the block's
    size); a cache block carries its spec (``keep_spec``)."""
    def cut(x, spec):
        blk = local_block(x, spec, mesh).clone()
        return keep_spec(blk, spec) if cache else blk
    return tree_map(cut, tree, specs)


def recording_mesh(multi_pod: bool = False) -> RecordingMesh:
    """The production mesh's rank at its last coordinate."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return RecordingMesh(shape, axes)


def cell_args(cfg, pcfg, cell: Cell, mesh: AbstractMesh, tcfg: Optional[TrainConfig] = None):
    """(step function, its arguments on this rank, those arguments by part)
    for a cell.  The train step takes the rank's blocks of the state and
    its batch rows; a serve step takes the rank's blocks of the parameters
    and the cache and the global inputs (it cuts its rows itself)."""
    ctx = cell.ctx
    if cell.kind == "train":
        state = S.abstract_train_state(cfg, pcfg)
        state = _blocks(state, S.train_state_shardings(cfg, pcfg, ctx, state), mesh)
        batch = _blocks(cell.abstract_args[0], cell.in_shardings[0], mesh)
        return (S.make_train_step(cfg, pcfg, tcfg or TrainConfig(), ctx), (state, batch),
                {"state": state, "inputs": batch})
    params = (E if cfg.enc_dec else T).init_abstract(cfg)
    params = _blocks(params, param_specs(params, cfg, ctx), mesh)
    cache = _blocks(cell.abstract_args[1], cell.in_shardings[1], mesh, cache=True)
    if cell.kind == "prefill":
        batch = cell.abstract_args[0]
        return (S.make_prefill_step(cfg, ctx), (params, batch, cache),
                {"state": params, "cache": cache, "inputs": batch})
    token, _, pos, *enc = cell.abstract_args
    return (S.make_decode_step(cfg, ctx=ctx), (params, token, cache, pos, *enc),
            {"state": params, "cache": cache, "inputs": (token, pos, *enc)})


def prepare_cell(arch: str, shape, mesh: AbstractMesh, pcfg=None, cfg_override=None,
                 tcfg: Optional[TrainConfig] = None):
    """(cell, cfg, pcfg, step function, its arguments, the arguments by
    part) of a cell on ``mesh``'s rank, nothing run: ``shape`` is a name in
    ``SHAPES`` or a ``ShapeConfig``, ``pcfg`` defaults to the planner's and
    ``tcfg`` (the train step's) to ``TrainConfig()``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg_override or _cell_cfg(arch, shape.kind)
    if cfg.layer_windows is not None:
        raise NotImplementedError(f"{cfg.name}: the dry run has no cells for per-layer "
                                  f"attention windows (layer_windows)")
    if hasattr(pcfg, "to_pcfg"):          # a first-class ParallelPlan
        pcfg = pcfg.to_pcfg()
    pcfg = pcfg or default_pcfg(arch, shape.kind, multi_pod="pod" in mesh.axis_names)
    cell = build_cell(cfg, shape, mesh, pcfg)
    return (cell, cfg, pcfg) + cell_args(cfg, pcfg, cell, mesh, tcfg)


def trace_cell(arch: str, shape, mesh: RecordingMesh, pcfg=None, cfg_override=None,
               tcfg: Optional[TrainConfig] = None) -> dict:
    """Runs one rank's step of the cell (``shape``: a name in ``SHAPES`` or
    a ``ShapeConfig``) on ``meta`` under the counting modes, on ``mesh``'s
    rank.  Returns the raw figures (FLOPs, bytes, memory with the
    arguments by part, collectives, staged bytes, the kernels' abstract
    launches, seconds), the cell, its configs and the step's output."""
    cell, cfg, pcfg, fn, args, parts = prepare_cell(arch, shape, mesh, pcfg, cfg_override,
                                                    tcfg)
    arg_bytes = _nbytes(args)
    # held through the step: the step replaces some argument tensors (a
    # recurrent state anew), and a freed storage's id could be taken by an
    # output's and counted as an alias
    arg_storages = {id(s): s for s in (t.untyped_storage() for t in _tensors(args))}
    staged0 = mesh.staged_bytes
    t0 = time.perf_counter()
    with _Counting() as op, _meta.tallying() as kt, FlopCounterMode(display=False) as fc:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    outs = _tensors(out)
    alias = sum(t.numel() * t.element_size() for t in outs
                if id(t.untyped_storage()) in arg_storages)
    return {"cell": cell, "pcfg": pcfg, "cfg": cfg, "out": out,
            "flops": fc.get_total_flops() + kt.flops, "kernel_flops": kt.flops,
            "bytes": op.bytes + kt.bytes,
            "kernel_launches": dict(kt.launches),
            "memory": {"argument_bytes": arg_bytes, "output_bytes": _nbytes(outs),
                       "temp_bytes": op.peak, "alias_bytes": alias,
                       "peak_estimate_bytes": arg_bytes + op.peak,
                       "arguments": {k: _nbytes(v) for k, v in parts.items()}},
            "collectives": mesh.collective_stats(),
            "staged_bytes": mesh.staged_bytes - staged0,
            "seconds": seconds}


def _routing(cfg) -> Optional[str]:
    return "balanced" if cfg.moe is not None and any(
        "moe" in k for k in cfg.block_pattern) else None


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             no_probes: bool = False) -> dict:
    """One cell's record, with JAX's keys (``no_probes`` changes nothing:
    there are no probes to skip)."""
    mesh = recording_mesh(multi_pod)
    n = mesh.size(mesh.axis_names)
    shape = SHAPES[shape_name]
    pcfg, cfg = _apply_overrides(default_pcfg(arch, shape.kind, multi_pod=multi_pod),
                                 _cell_cfg(arch, shape.kind))
    sharding.reset_dropped_partitions()
    raw = trace_cell(arch, shape_name, mesh, pcfg=pcfg, cfg_override=cfg)
    cell = raw["cell"]
    flops_dev, bytes_dev = float(raw["flops"]), float(raw["bytes"])
    coll = raw["collectives"]
    trips = cfg.n_layers if cfg.enc_dec else cfg.n_periods
    has_chunks = (cfg.ssm is not None or cfg.xlstm is not None) and shape.kind != "decode"
    chunk = (cfg.ssm.chunk if cfg.ssm else cfg.xlstm.chunk) if has_chunks else 1
    pc = cfg.param_counts()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        model_flops = costmodel.model_flops_train(pc["active"], tokens)
    else:
        model_flops = 2.0 * pc["active"] * tokens
    terms = costmodel.roofline_terms(flops_dev * n, bytes_dev * n, coll["wire_bytes"] * n, n)
    rec = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n, "rank": mesh.rank,
        "flops_per_device": flops_dev,
        "hlo_flops_global": flops_dev * n,
        "bytes_per_device": bytes_dev,
        "bytes_kind": "eager op-by-op operand and result bytes (not XLA's fused count)",
        "collectives": coll,
        "collectives_corrected": copy.deepcopy(coll),
        "memory": raw["memory"],
        "scan_trips": trips,
        "chunk_trips": max(1, shape.seq_len // chunk) if has_chunks else 1,
        "flops_moe_overcount_per_device": 0.0,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / max(flops_dev * n, 1.0),
        "roofline": terms,
        "compile_s": raw["seconds"], "probe_s": 0.0,
        "batch_axes": list(cell.ctx.batch_axes),
        "sharding_dropped": sharding.dropped_partition_report(),
        "routing": _routing(cfg),
        "staged_bytes": raw["staged_bytes"],
        "kernel_launches": raw["kernel_launches"],
    }
    if verbose:
        mem = rec["memory"]
        print(f"[{arch} × {shape_name} × {rec['mesh']}] "
              f"compile {rec['compile_s']:.1f}s+{rec['probe_s']:.1f}s  "
              f"mem/dev args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB  "
              f"flops/dev={rec['flops_per_device']:.3e}  "
              f"useful={rec['useful_flops_ratio']:.2f}  "
              f"dominant={terms['dominant']} ({terms['bound_s']*1e3:.2f} ms)"
              + (f"  dropped_shards={len(rec['sharding_dropped'])}"
                 if rec["sharding_dropped"] else ""), flush=True)
        print("  memory:", rec["memory"])
        print("  rank %d %s, staged %d B, kernels %s, routing %s" %
              (rec["rank"], mesh.coords, rec["staged_bytes"], rec["kernel_launches"],
               rec["routing"]))
        print("  counted: flops/dev=%.4e bytes/dev=%.4e wire/dev=%.4e" %
              (rec["flops_per_device"], rec["bytes_per_device"], coll["wire_bytes"]))
        print("  collectives:", json.dumps(coll["per_op"]), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    # the hill-climb knobs (grad-barrier and manual-attention set knobs that
    # nothing in the eager port reads)
    ap.add_argument("--hc-seq-parallel", action="store_true")
    ap.add_argument("--hc-a2a-ep", action="store_true")
    ap.add_argument("--hc-engine-replicate", action="store_true")
    ap.add_argument("--hc-mm-bf16", action="store_true")
    ap.add_argument("--hc-remat", default=None, choices=["none", "dots", "full"])
    ap.add_argument("--hc-logit-chunk", type=int, default=None)
    ap.add_argument("--hc-no-fsdp", action="store_true")
    ap.add_argument("--hc-master-bf16", action="store_true")
    ap.add_argument("--hc-grad-barrier", action="store_true")
    ap.add_argument("--hc-manual-attention", action="store_true")
    ap.add_argument("--hc-dp-over-model", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the JAX dry run's command lines; the port "
                         "counts every layer as it runs and has no probes")
    args = ap.parse_args(argv)
    HILLCLIMB_OVERRIDES["pcfg"].clear()
    HILLCLIMB_OVERRIDES["cfg"].clear()
    if args.hc_seq_parallel:
        HILLCLIMB_OVERRIDES["pcfg"]["sequence_parallel"] = True
    if args.hc_a2a_ep:
        HILLCLIMB_OVERRIDES["pcfg"]["moe_a2a_ep"] = True
    if args.hc_engine_replicate:
        HILLCLIMB_OVERRIDES["pcfg"]["engine_replicate"] = True
    if args.hc_remat:
        HILLCLIMB_OVERRIDES["pcfg"]["remat"] = args.hc_remat
    if args.hc_logit_chunk:
        HILLCLIMB_OVERRIDES["pcfg"]["logit_chunk"] = args.hc_logit_chunk
    if args.hc_no_fsdp:
        HILLCLIMB_OVERRIDES["pcfg"]["fsdp_params"] = False
        HILLCLIMB_OVERRIDES["pcfg"]["fsdp_pod"] = False
    if args.hc_mm_bf16:
        HILLCLIMB_OVERRIDES["cfg"]["mm_bf16"] = True
    if args.hc_master_bf16:
        HILLCLIMB_OVERRIDES["pcfg"]["master_weights"] = True
    if args.hc_grad_barrier:
        HILLCLIMB_OVERRIDES["pcfg"]["grad_barrier"] = True
    if args.hc_manual_attention:
        HILLCLIMB_OVERRIDES["pcfg"]["manual_attention"] = True
    if args.hc_dp_over_model:
        HILLCLIMB_OVERRIDES["pcfg"]["dp_over_model"] = True

    results = []
    if args.all:
        todo = list(configs.cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape, False)]

    failures = []
    for arch, shape_name, skip in todo:
        if skip:
            results.append({"arch": arch, "shape": shape_name, "skipped": True,
                            "reason": "full-attention arch; long_500k requires "
                                      "sub-quadratic attention (DESIGN.md §4)"})
            print(f"[{arch} × {shape_name}] SKIP (full attention)")
            continue
        try:
            results.append(run_cell(arch, shape_name, args.multi_pod,
                                    no_probes=args.no_probes))
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape_name, str(e)))
            results.append({"arch": arch, "shape": shape_name, "error": str(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:", *[f"{a}×{s}: {e[:200]}" for a, s, e in failures],
              sep="\n")
        sys.exit(1)
    print(f"\nall {len(results)} cells OK")
    return results


if __name__ == "__main__":
    main()
