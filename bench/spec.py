"""Finding a cell's parts by name, so that a new configuration, traffic mix
or per-layer metric is a new file and never an edit.

  * ``BENCHMARK.json`` at the root names the cells, the configurations'
    files and the metrics;
  * ``bench/traffic/<mix>.json`` is a traffic mix (``traffic.py`` reads it);
  * ``bench/metrics/<metric>.py`` is a per-layer metric's reader: a
    function ``read(m)`` of the measured run (``harness.Measured``) that
    returns the value, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; have {[e['name'] for e in entries]}")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "config")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "bench" / "traffic" / f"{name}.json").read_text())


def metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    with no ``workloads`` key and those that list the cell."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
