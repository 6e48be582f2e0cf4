"""The readings that the limits of ``correct`` are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s> [--control] [--untapped]

For each seed, in one process: the cell's weights (from its model module's
``leaf_plan``) and traffic, the timed path through the logits tap at the
cell's own load for ``--seconds`` (a benchmark run's window), then the
model module over the run's sample.  Prints one JSON line a seed: every
statistic under ``bench/checks/`` of the program and, with ``--control``,
of the float8 control at the same positions.  With ``--untapped`` the seed
is served a second time without the tap, and the line says how many tokens
of the requests both runs served differ.  The lines also go to
``chiprun_out/calibrate.<cell>.jsonl``.  Benchmark runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def stats(side) -> dict:
    """Every statistic of ``bench/checks/`` on one side of the comparison."""
    from bench import spec
    if side is None:
        return {}
    out = {"tokens": int(side["gaps"].size), "positions_tapped": int(side["err"].size)}
    for path in sorted((ROOT / "bench" / "checks").glob("*.py")):
        out[path.stem] = spec.statistic(path.stem)(side)
    return out


def differing(a, b) -> dict:
    """Tokens that two runs' recordings both hold, request by request, and
    how many of them differ."""
    n = diff = 0
    for x, y in zip(a.tokens, b.tokens):
        k = min(len(x), len(y))
        n += k
        diff += sum(1 for i in range(k) if x[i] != y[i])
    return {"tokens": n, "differ": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--untapped", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from bench import check, harness
    out = ROOT / "chiprun_out" / f"calibrate.{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sv = harness.serve_cell(args.workload, seed, args.seconds)
        run = sv.run
        t1 = time.perf_counter()
        cmp = check.compare(run, sv.params, sv.cfg["model"], sv.prompts, seed,
                            sv.mix["check"], torch.device("cuda"), logits=sv.module.logits,
                            tap=sv.tap, control=args.control)
        t2 = time.perf_counter()
        row = {"cell": args.workload, "seed": seed, "program": stats(cmp["program"]),
               "control": stats(cmp["control"]), "bad_ids": cmp["bad_ids"],
               "requests_compared": len(cmp["rids"]), "attempted": int(len(run.attempted())),
               "out_tokens": run.out_tokens(), "setup_s": run.open - t0,
               "kv_live_share": 100.0 * run.kv_live_tokens() / harness.kv_capacity(sv.mix["engine"]),
               "serve_s": t1 - t0, "check_s": t2 - t1, "memory_peak_bytes": int(sv.peak),
               "card": harness.power_limit()}
        del sv, cmp
        torch.cuda.empty_cache()
        if args.untapped:
            plain = harness.serve_cell(args.workload, seed, args.seconds, tapped=False)
            row["untapped"] = dict(differing(run, plain.run),
                                   out_tokens=plain.run.out_tokens(),
                                   memory_peak_bytes=int(plain.peak))
            del plain
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
