"""No module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro`` is loaded by the harness, and the reference, and every model
module that a configuration names, loads nothing of the program.  Each
check runs in a fresh interpreter: the test process itself may hold JAX
from other test files."""
import json
import subprocess
import sys

import pytest

import bench_tiny
from bench import spec

REPO = bench_tiny.REPO
PROGRAM = {"jax", "jaxlib", "flax", "repro", "repro_torch"}

DRY_LOAD = """
import json, sys, runpy, tempfile
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[1] + "/bench/tests"]
runpy.run_path(sys.argv[1] + "/bench/run.py", run_name="bench_run")
import bench_tiny
from bench import harness
root = bench_tiny.make_root(Path(tempfile.mkdtemp()))
harness.run_cell("m.aligned", 3, 1.0, True, root=root, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package():
    mods = _modules(DRY_LOAD)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys\nsys.path.insert(0, sys.argv[1])\nimport bench.reference\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    mods = _modules(code)
    assert not mods & PROGRAM


LOAD_MODULE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from bench import spec
mod = spec.load(sys.argv[2], "bench_model")
assert callable(mod.logits) and callable(mod.leaf_plan)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _configured_modules():
    bench = spec.benchmark(REPO)
    return sorted({c["reference"] for c in (spec.config(bench, e["name"], REPO)
                                            for e in bench["configs"]) if "reference" in c})


@pytest.mark.parametrize("path", ["tiny copy"] + _configured_modules())
def test_every_model_module_a_configuration_names_loads_nothing_of_the_program(path, tmp_path):
    """The repository's configurations' modules, and a copy of the
    reference as a test configuration names one."""
    if path == "tiny copy":
        path = tmp_path / bench_tiny.model_module(tmp_path, "tinycopy")
    out = subprocess.run([sys.executable, "-c", LOAD_MODULE, str(REPO), str(REPO / path)],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & PROGRAM


def test_forbidden_modules_are_found_by_their_top_level_name(monkeypatch):
    import types
    from bench import harness
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    monkeypatch.setitem(sys.modules, "repro_torchish", types.ModuleType("repro_torchish"))
    assert "flax" in harness.forbidden_modules()
    assert "repro_torchish" not in harness.forbidden_modules()
