"""The readings that the limits of ``correct`` are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s> [--control]

For each seed, in one process: the cell's weights and traffic, the timed
path at the cell's own load for ``--seconds`` (a benchmark run's window),
then the reference over the run's sample.  Prints one JSON line a seed:
the program's gaps (widest, mean, share of served tokens that are not the
reference's argmax) and, with ``--control``, the same of the float8
control at the same positions.  The lines also go to
``chiprun_out/calibrate.<cell>.jsonl``.  Benchmark runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def stats(g) -> dict:
    if not g.size:
        return {"tokens": 0}
    return {"tokens": int(g.size), "max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch": float((g > 0).mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from bench import check, harness
    out = ROOT / "chiprun_out" / f"calibrate.{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, cfg, mix, params, prompts, run, _, peak = harness.serve_cell(
            args.workload, seed, args.seconds)
        t1 = time.perf_counter()
        cmp = check.compare(run, params, cfg["model"], prompts, seed, mix["check"],
                            torch.device("cuda"), control=args.control)
        t2 = time.perf_counter()
        row = {"cell": args.workload, "seed": seed, "program": stats(cmp["program"]),
               "control": stats(cmp["control"]), "bad_ids": cmp["bad_ids"],
               "requests_compared": len(cmp["rids"]), "attempted": int(len(run.attempted())),
               "out_tokens": run.out_tokens(), "setup_s": run.open - t0,
               "kv_live_share": 100.0 * run.kv_live_tokens() / harness.kv_capacity(mix["engine"]),
               "serve_s": t1 - t0, "check_s": t2 - t1, "memory_peak_bytes": int(peak),
               "card": harness.power_limit()}
        print(json.dumps(row), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        del params, run, cmp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
