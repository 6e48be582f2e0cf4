"""Finding a cell's parts by name, so that a new configuration, traffic mix
or per-layer metric is a new file and never an edit.

  * ``BENCHMARK.json`` at the root names the cells, the configurations'
    files and the metrics;
  * ``bench/traffic/<mix>.json`` is a traffic mix (``traffic.py`` reads it);
  * ``bench/metrics/<metric>.py`` is a per-layer metric's reader: a
    function ``read(m)`` of the measured run (``harness.Measured``) that
    returns the value, or None where it finds nothing to read;
  * ``bench/checks/<stat>.py`` is a statistic of the check: a function
    ``read(cmp)`` of one side of the comparison (``check.compare``) that
    returns the number compared, or None where it has nothing to read.  A
    configuration file's ``check`` names its statistics and their limits;
  * a configuration file's ``reference`` (``bench/models/<name>.py``, a
    path from the root) is its model module: ``logits(params, model,
    tokens, n_out, *, fp8=False)`` and ``leaf_plan(model)``, importing
    only torch.  Without the key, ``bench/reference.py``'s ``logits`` and
    ``weights.leaf_plan``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

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


def load(path: Path, prefix: str):
    """The module in the file ``path``, loaded under a name of its own."""
    path = Path(path)
    name = f"{prefix}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return load(Path(root) / "bench" / "metrics" / f"{name}.py", "bench_metric").read


def statistic(name: str, root: Path = ROOT):
    """The ``read`` function of ``bench/checks/<name>.py``."""
    return load(Path(root) / "bench" / "checks" / f"{name}.py", "bench_check").read


def model_module(cfg: dict, root: Path = ROOT):
    """The configuration's model module: the file its ``reference`` names,
    or ``bench/reference.py``'s ``logits`` with ``weights.leaf_plan``."""
    if "reference" in cfg:
        return load(Path(root) / cfg["reference"], "bench_model")
    from bench import reference, weights
    return SimpleNamespace(logits=reference.logits, leaf_plan=weights.leaf_plan)
