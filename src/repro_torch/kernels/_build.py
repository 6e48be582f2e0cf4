"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries go to
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a hash
of every file under ``csrc/``, so an edited source builds anew and a stale
library is never loaded.  Nothing is built when a module is imported: the
first launch builds what it needs, and ``build()`` builds every source at
once (one ``nvcc`` per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def _build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(SRC_DIR.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return _build_dir() / f"lib{name}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all running at once.  Returns, per kernel,
    the wall seconds of its build (0.0 when it was already built) and the
    compiler's resource report (``ptxas`` lines).  Raises with the
    compiler's output if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no kernel source for {unknown}; have {sorted(srcs)}")
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for n in names:
        lib = out_dir / f"lib{n}.so"
        if lib.exists():
            report[n] = {"seconds": 0.0, "ptxas": (out_dir / f"{n}.log").read_text()
                         if (out_dir / f"{n}.log").exists() else ""}
            continue
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, lib)
    failed = []
    for n, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)           # atomic: a reader never sees half a file
        report[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
