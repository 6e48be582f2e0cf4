"""Fill a Markdown file's placeholders from the dry-run and hill-climb
records: the port of the JAX package's ``launch/report.py``.

The regions between ``<!-- NAME -->`` and ``<!-- /NAME -->`` of the target
file are replaced (idempotently) by the roofline tables of the dry-run
records (``ROOFLINE_16x16``, and ``ROOFLINE_2x16x16`` when a multi-pod
record file is given) and by the hill-climb table (``PERF_LOG``, when
``hc_*.json`` files are given).  Only the file the caller names is
written.

  PYTHONPATH=src python -m repro_torch.launch.report --dryrun dry16.json \\
      [--multi-pod dry2x16.json] [--hc hc_a.json ...] --target REPORT.md
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional, Sequence

from repro_torch.launch.roofline import fraction_of_roofline, table


def hc_rows(dryrun_16x16: str, hc_paths: Sequence[str]) -> str:
    """Hill-climb result lines, compared against the baseline cells of
    ``dryrun_16x16``; each ``hc_<name>.json`` holds one run's records."""
    base = {}
    with open(dryrun_16x16) as f:
        for r in json.load(f):
            if "roofline" in r:
                base[(r["arch"], r["shape"])] = r
    lines = []
    for path in sorted(hc_paths):
        name = os.path.basename(path)[3:-5]
        with open(path) as f:
            rows = json.load(f)
        if not rows or "roofline" not in rows[0]:
            lines.append(f"| {name} | FAILED | | | | |")
            continue
        r = rows[0]
        b = base.get((r["arch"], r["shape"]))
        t, bt = r["roofline"], b["roofline"]
        lines.append(
            f"| {name} | {r['arch']}×{r['shape']} | "
            f"{bt['bound_s']:.3f}→{t['bound_s']:.3f} "
            f"({bt['bound_s']/max(t['bound_s'],1e-12):.1f}×) | "
            f"{bt['dominant'].replace('_s','')}→{t['dominant'].replace('_s','')} | "
            f"{fraction_of_roofline(b):.4f}→{fraction_of_roofline(r):.4f} | "
            f"c={t['compute_s']:.2f} m={t['memory_s']:.2f} "
            f"x={t['collective_s']:.2f} |")
    return "\n".join(lines)


def _fill(text, name, body):
    """Idempotent region fill between <!-- name --> and <!-- /name -->."""
    return re.sub(rf"<!-- {name} -->.*?<!-- /{name} -->",
                  f"<!-- {name} -->\n{body}\n<!-- /{name} -->", text, flags=re.S)


def fill(text: str, dryrun_16x16: str, dryrun_2x16x16: Optional[str] = None,
         hc_paths: Sequence[str] = ()) -> str:
    """``text`` with its regions filled from the record files."""
    t1 = table(dryrun_16x16)
    text = _fill(text, "ROOFLINE_16x16",
                 f"\n### 16×16 (single pod, corrected)\n\n{t1}\n")
    if dryrun_2x16x16 and os.path.exists(dryrun_2x16x16):
        t2 = table(dryrun_2x16x16)
        text = _fill(text, "ROOFLINE_2x16x16",
                     "\n### 2×16×16 (multi-pod shard-proof pass; single "
                     "compile, uncorrected scan trip counts — see §Dry-run "
                     f"methodology)\n\n{t2}\n")
    if hc_paths:
        hdr = ("| run | cell | bound_s before→after | dominant | "
               "roofline-frac | terms after |\n|---|---|---|---|---|---|")
        text = _fill(text, "PERF_LOG", f"\n{hdr}\n{hc_rows(dryrun_16x16, hc_paths)}\n")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", required=True, help="the 16x16 dry-run records (JSON)")
    ap.add_argument("--multi-pod", default=None, help="the 2x16x16 dry-run records (JSON)")
    ap.add_argument("--hc", nargs="*", default=[], help="hill-climb records, hc_<name>.json")
    ap.add_argument("--target", required=True, help="the Markdown file to fill in place")
    args = ap.parse_args(argv)
    with open(args.target) as f:
        text = f.read()
    text = fill(text, args.dryrun, args.multi_pod, args.hc)
    with open(args.target, "w") as f:
        f.write(text)
    print(f"{args.target} updated")


if __name__ == "__main__":
    main()
