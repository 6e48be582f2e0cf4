"""Import hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package (``repro``); the port keeps its own
copies of what it needs.  Only the tests import both."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _offending_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _banned(node.module):
                bad.append(node.module)
    return bad


def test_port_sources_import_no_jax_and_no_reference_package():
    assert len(PORT_FILES) > 10
    found = {str(p.relative_to(ROOT)): _offending_imports(p) for p in PORT_FILES}
    assert {k: v for k, v in found.items() if v} == {}


def test_banned_import_detector():
    assert _banned("jax.numpy") and _banned("repro.models.layers") and _banned("repro")
    assert not _banned("repro_torch.models") and not _banned("torch")


def test_serve_entry_point_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_core_loads_no_jax():
    """The distributed path (mesh, algebra, grids, matmuls, Floyd-Warshall)
    and its kernels load neither JAX nor the reference package."""
    code = ("import sys, repro_torch.core, repro_torch.kernels.ops; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_mesh_trainer_loads_no_jax():
    """The SPMD layer (tensor-parallel ops, sharding rules, the planner,
    the mesh constructors, MeshCtx, the cells and their cache specs, the
    roofline tables) and the mesh trainer load neither JAX nor the
    reference package."""
    code = ("import sys, repro_torch.core.tensor_ops, repro_torch.parallel.sharding, "
            "repro_torch.parallel.planner, repro_torch.launch.mesh, repro_torch.models.moe, "
            "repro_torch.launch.specs, repro_torch.launch.roofline, repro_torch.launch.train; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_model_families_load_no_jax():
    """The MoE, Mamba2, xLSTM and enc-dec modules and the serve / train
    launchers that reach them load neither JAX nor the reference package."""
    code = ("import sys, repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.xlstm, repro_torch.models.encdec, repro_torch.convert, "
            "repro_torch.launch.train, repro_torch.launch.serve; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
