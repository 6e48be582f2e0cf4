"""Checkpoints on the JAX package's on-disk layout: one .npy per leaf, a
JSON manifest, and atomic step-fenced commits.

Layout:
  <dir>/step_<k>.tmp/         -- in-progress write
  <dir>/step_<k>/             -- committed (atomic rename)
      manifest.json           -- step, leaf shapes and dtypes, process count
      <leafpath>.proc0.npy    -- the leaf's data

A leaf's path joins its dict keys and sequence indices with ``__`` in
pytree order (``repro_torch.tree``), so a tree of the same structure gets
the same names in both packages and either package reads the other's
checkpoint.  numpy has no bfloat16 without the ``ml_dtypes`` package, which
the port does not need: a bf16 leaf is stored as its 16-bit pattern (a
``uint16`` array) with ``"bfloat16"`` in the manifest.  JAX's own bf16
files hold the same 16-bit pattern under a void (``|V2``) header, which is
what ``np.load`` returns without ``ml_dtypes``; ``restore_checkpoint`` reads
both through the manifest's dtype.

``AsyncCheckpointer`` moves serialization + fsync off the training thread.
``ShardedCheckpointer`` saves a state held as blocks on the ranks of a mesh
in the same layout of full leaves (one writer), and ``restore_checkpoint``'s
``transform`` cuts each full leaf to a rank's block as it is read: a
checkpoint written by p ranks restores on any number, and in JAX.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.mesh import ProcessMesh, assemble
from repro_torch.tree import leaves, leaves_with_path, tree_map, tree_unflatten

Tree = Any

_SEP = "__"


class _Host:
    """A leaf copied to the host: its numpy data and its dtype's name."""
    __slots__ = ("array", "dtype")

    def __init__(self, leaf):
        if isinstance(leaf, _Host):
            self.array, self.dtype = leaf.array, leaf.dtype
        elif torch.is_tensor(leaf):
            t = leaf.detach().to("cpu", copy=True)    # never a view of the leaf
            if t.dtype == torch.bfloat16:
                self.array, self.dtype = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
            else:
                self.array = t.numpy()
                self.dtype = str(self.array.dtype)
        else:
            self.array = np.asarray(leaf)
            self.dtype = str(self.array.dtype)


def _flatten(tree: Tree) -> dict:
    return {_SEP.join(str(k) for k in path): leaf for path, leaf in leaves_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for key, leaf in _flatten(tree).items():
        h = _Host(leaf)
        np.save(os.path.join(tmp, f"{key}.proc0.npy"), h.array)
        manifest[key] = {"shape": list(h.array.shape), "dtype": h.dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest, "process_count": 1}, f)
    os.replace(tmp, final)  # atomic commit fence
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def restore_checkpoint(directory: str, step: int, like: Tree, device=None,
                       transform=None) -> Tree:
    """Restore into the structure of ``like`` (real or ``meta`` tensors),
    with the dtypes the checkpoint stored.  Each leaf goes to ``device``, or
    to ``like``'s leaf's device when ``device`` is None (a ``meta`` leaf then
    needs an explicit ``device``).  ``transform(path, leaf)`` replaces each
    leaf as it is read (a rank keeps its block), so the whole tree is never
    held at once."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    paths = {_SEP.join(str(k) for k in p): p for p, _ in leaves_with_path(like)}
    out = []
    for key, leaf in _flatten(like).items():
        dev = device if device is not None else getattr(leaf, "device", "cpu")
        if torch.device(dev).type == "meta":
            raise ValueError("restore_checkpoint: pass device= to restore a meta tree")
        t = _load(os.path.join(path, f"{key}.proc0.npy"), manifest[key]["dtype"]).to(dev)
        out.append(t if transform is None else transform(paths[key], t))
    return tree_unflatten(like, out)


class AsyncCheckpointer:
    """Fire-and-forget background checkpoint writer with a single in-flight
    slot (back-pressure if the previous save hasn't finished)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        # copy to the host *before* backgrounding: the next step rewrites
        # the device tensors in place
        host_tree = tree_map(_Host, tree)

        def _run():
            try:
                save_checkpoint(self.directory, step, host_tree)
            except Exception as e:   # raised by the next wait()
                self._error = e
                return
            self.last_committed = step

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight has committed; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class ShardedCheckpointer:
    """Checkpoints of a state held as blocks on the ranks of ``mesh`` (laid
    out by the spec tree ``specs``), in the layout of full leaves.

    ``save`` assembles each leaf from its blocks (every rank takes part,
    leaf by leaf in one order) and rank 0 writes the full tree in the
    background (``AsyncCheckpointer``).  ``wait`` is the fence: it returns
    on every rank only after rank 0's commit, so every rank then reads the
    same ``latest_step``."""

    def __init__(self, directory: str, mesh: ProcessMesh, specs: Tree):
        self.mesh, self.specs = mesh, specs
        self._writer = AsyncCheckpointer(directory) if mesh.rank == 0 else None

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        with torch.no_grad():
            full = []
            for x, spec in zip(leaves(tree), leaves(self.specs)):
                whole = assemble(x, spec, self.mesh)
                full.append(whole if self._writer is not None else None)
                del whole
        if self._writer is not None:
            self._writer.save(step, tree_unflatten(tree, full))

    def wait(self) -> None:
        """Block until the save in flight has committed on rank 0, on every
        rank; raise its error (on rank 0, after the fence)."""
        err = None
        if self._writer is not None:
            try:
                self._writer.wait()
            except Exception as e:   # raised after the fence, so no rank hangs
                err = e
        torch.distributed.barrier()
        if err is not None:
            raise err
