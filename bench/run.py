"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then the card's power limit and the
numbers compared for ``correct``, each beside its limit.  Those numbers are
also the last lines of standard error.  Exits non-zero, with no result,
without as many CUDA devices as the cell asks for, or if the process holds
``jax``, ``jaxlib``, ``flax`` or ``repro`` once the window has closed.

The port builds its kernels with nvcc into ``build/repro_torch_kernels/``
inside the checkout, so only the first run in a checkout compiles.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")

    import torch
    from bench import harness, spec
    chips = spec.cell(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds modules it must not: {found}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
