"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries go to
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a hash
of every file under ``csrc/``, so an edited source builds anew and a stale
library is never loaded.  Nothing is built when a module is imported: the
first launch builds what it needs, and ``build()`` builds every source at
once (one ``nvcc`` per source, all started together).

A source may also be built as a variant: a job ``(name, defines)`` passes
each ``(macro, value)`` of ``defines`` to ``nvcc`` as ``-Dmacro=value`` and
builds its own library, so a source whose macros select one template
instantiation compiles only the one a caller launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

Defines = Tuple[Tuple[str, int], ...]
Job = Union[str, Tuple[str, Defines]]

_loaded: Dict[Job, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def _build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(SRC_DIR.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _stem(job: Job) -> str:
    """The library's name: the source's, then each define's value."""
    if isinstance(job, str):
        return job
    name, defines = job
    return ".".join([name] + [str(v) for _, v in defines])


def library_path(job: Job) -> Path:
    return _build_dir() / f"lib{_stem(job)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def build(names: Optional[Iterable[Job]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: every source whole) that are not
    built yet, each a source's name or a variant ``(name, defines)``, one
    ``nvcc`` process per job, all running at once.  Returns, per library
    name, the wall seconds of its build (0.0 when it was already built)
    and the compiler's resource report (``ptxas`` lines).  Raises with the
    compiler's output if any build fails."""
    srcs = sources()
    jobs = list(srcs) if names is None else list(names)
    unknown = [j for j in jobs if (j if isinstance(j, str) else j[0]) not in srcs]
    if unknown:
        raise KeyError(f"no kernel source for {unknown}; have {sorted(srcs)}")
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for job in jobs:
        n = _stem(job)
        lib = out_dir / f"lib{n}.so"
        if lib.exists():
            report[n] = {"seconds": 0.0, "ptxas": (out_dir / f"{n}.log").read_text()
                         if (out_dir / f"{n}.log").exists() else ""}
            continue
        src, defines = (job, ()) if isinstance(job, str) else job
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines),
                                      "-o", str(tmp), str(srcs[src])],
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


def load(name: str, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (the variant of ``defines``,
    if any), built first if needed."""
    job = (name, defines) if defines else name
    lib = _loaded.get(job)
    if lib is None:
        path = library_path(job)
        if not path.exists():
            build([job])
        lib = _loaded[job] = ctypes.CDLL(str(path))
    return lib
