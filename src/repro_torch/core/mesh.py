"""The process mesh and the SPMD runner: the port's counterpart of
``shard_map`` over a JAX mesh.

The JAX package runs a FooPar program as one ``shard_map`` body over a mesh of
devices (``core/compat.py``, ``grid.py::make_grid_mesh``,
``dseq.py::spmd``).  Here the p "devices" are p processes on the **gloo**
backend of ``torch.distributed``, all on one card (NCCL cannot put several
ranks on one device) or on the CPU:

* ``launch(p, fn, *args, device=)`` starts the p rank processes (spawn start
  method, rendezvous through a ``FileStore`` in a temporary directory, a
  timeout on the group and every collective) and returns each rank's result;
* ``ProcessMesh(shape, axis_names)`` lays a Cartesian mesh over those ranks,
  row-major like ``jax.make_mesh`` (on (2, 2, 2): rank = i*4 + j*2 + k), with
  one communication group per axis and per fixed value of the other
  coordinates;
* ``spmd(body, mesh, in_specs, out_specs)`` slices global inputs to the rank's
  block by spec (views: no data moves), runs ``body`` inside the mesh, and
  assembles the outputs by spec;
* ``RecordingMesh(shape, axis_names, coords)`` is one rank of a mesh with no
  processes behind it, for the dry run (``launch/dryrun.py``): its
  collectives return empty ``meta`` blocks and tally what they would move.

**Transport.**  Every payload is staged through a host buffer (pinned when
the tensor is on the card) and back, by one code path for every operation, so
the CPU tests run the same path as the card.  The data lives on the rank's
device and every local product runs there; only messages cross the host.
``ProcessMesh.staged_bytes`` counts the bytes copied each way, and
``ProcessMesh.comm_seconds`` the host time spent inside the blocking
all-reduce, all-gather, all-to-all and reduce-scatter, from the moment the
device has finished the work queued before each (so it counts the staging
copies, the transfer and the wait for the group's other ranks, not this
rank's own device work).
"""
from __future__ import annotations

import functools
import itertools
import math
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Axes = Tuple[str, ...]
_ACTIVE: List["ProcessMesh"] = []      # the mesh a running spmd body is inside


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: entry d names the
    mesh axis (or a tuple of axes, split row-major) that splits dimension
    d, or is None (not split).  A one-axis tuple is that axis, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))


def current() -> "ProcessMesh":
    """The mesh of the spmd body that is running on this rank."""
    if not _ACTIVE:
        raise RuntimeError("no active ProcessMesh: group operations run inside "
                           "spmd(...) or a `with mesh:` block")
    return _ACTIVE[-1]


def _clocked(method):
    """Adds the call's host time to ``self.comm_seconds``, after waiting for
    the device work queued before it (a device-to-host copy waits for it
    anyway)."""
    @functools.wraps(method)
    def run(self, x, *args, **kwargs):
        if x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        try:
            return method(self, x, *args, **kwargs)
        finally:
            self.comm_seconds += time.perf_counter() - t0
    return run


class Pending:
    """An issued transfer.  ``wait()`` completes it and returns the value."""

    def __init__(self, works, finish: Callable[[], Any], keep=()):
        # ``keep`` holds the staged buffers until the transfer completes
        self._works, self._finish, self._keep = works, finish, keep

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


class AbstractMesh:
    """A mesh's shape and axis names with no processes behind it (JAX's
    ``AbstractMesh``): what the sharding rules and the planner read."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axes {self.axis_names} differ in rank")

    def _axes(self, axes) -> Axes:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(pos) or len(set(pos)) != len(pos):
            raise ValueError(f"axes {axes} must be distinct and in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def size(self, axes) -> int:
        return math.prod(self.shape[self.axis_names.index(a)] for a in self._axes(axes))


class ProcessMesh(AbstractMesh):
    """A Cartesian mesh over the ranks of the default process group.

    Every rank must build the same meshes in the same order: creating a
    group is collective over the whole world, members or not."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        super().__init__(shape, axis_names)
        world = dist.get_world_size()
        if math.prod(self.shape) != world:
            raise ValueError(f"mesh {self.shape} needs {math.prod(self.shape)} ranks; "
                             f"the process group has {world}")
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.shape))
        self.staged_bytes = 0
        self.comm_seconds = 0.0
        self._groups = {}
        for a in self.axis_names:
            self._group((a,))

    # -- coordinates -------------------------------------------------------
    def index(self, axes) -> int:
        """This rank's linear index over ``axes`` (row-major)."""
        idx = 0
        for a in self._axes(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def _group(self, axes):
        """(group, global ranks in linear order over ``axes``) of this rank's
        group varying in ``axes``.  The first call for a set of axes creates
        the groups of every fixed value of the other coordinates, in one order
        on every rank; a one-rank group has no process group (None)."""
        axes = self._axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        var = [self.axis_names.index(a) for a in axes]
        fixed = [i for i in range(len(self.shape)) if i not in var]
        mine = None
        for rest in itertools.product(*(range(self.shape[i]) for i in fixed)):
            members = []
            for vals in itertools.product(*(range(self.shape[i]) for i in var)):
                c = [0] * len(self.shape)
                for i, v in zip(fixed, rest):
                    c[i] = v
                for i, v in zip(var, vals):
                    c[i] = v
                members.append(int(np.ravel_multi_index(c, self.shape)))
            group = dist.new_group(members) if len(members) > 1 else None
            if self.rank in members:
                mine = (group, members)
        self._groups[axes] = mine
        return mine

    def make_groups(self, *axes_sets) -> None:
        """Create the groups of each set of axes now: a collective over the
        whole world, so every rank calls it at the same point."""
        for axes in axes_sets:
            if axes:
                self._group(axes)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    # -- transport: host staging ------------------------------------------
    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        h.copy_(x)
        self.staged_bytes += h.numel() * h.element_size()
        return h

    def _host_buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype, pin_memory=like.is_cuda)

    def _to_device(self, h: torch.Tensor, device) -> torch.Tensor:
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(device, non_blocking=True)

    # -- collectives (group-relative indices, as in JAX) -------------------
    @_clocked
    def all_reduce(self, x: torch.Tensor, op: str, axes) -> torch.Tensor:
        group, members = self._group(axes)
        if group is None:
            return x
        h = self._to_host(x)
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(h, op=red, group=group)
        return self._to_device(h, x.device)

    def broadcast(self, x: torch.Tensor, src: int, axes) -> torch.Tensor:
        """Every rank of the group gets element ``src``'s ``x``."""
        group, members = self._group(axes)
        if group is None:
            return x
        me = members.index(self.rank)
        h = self._to_host(x) if me == src else self._host_buffer(x.shape, x)
        dist.broadcast(h, src=dist.get_global_rank(group, src), group=group)
        return x if me == src else self._to_device(h, x.device)

    @_clocked
    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """(p, *x.shape): element i of the group at position i."""
        group, members = self._group(axes)
        if group is None:
            return x[None]
        h = self._to_host(x)
        parts = [self._host_buffer(x.shape, x) for _ in members]
        dist.all_gather(parts, h, group=group)
        return self._to_device(torch.stack(parts), x.device)

    @_clocked
    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Chunk i of the leading dim goes to element i; the received chunks
        are concatenated in source order."""
        group, members = self._group(axes)
        if group is None:
            return x
        h = self._to_host(x)
        out = self._host_buffer(x.shape, x)
        dist.all_to_all_single(out, h, group=group)
        return self._to_device(out, x.device)

    @_clocked
    def reduce_scatter_sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the group; element i keeps chunk i of the leading dim."""
        group, members = self._group(axes)
        if group is None:
            return x
        p = len(members)
        h = self._to_host(x)
        out = self._host_buffer((x.shape[0] // p,) + tuple(x.shape[1:]), x)
        dist.reduce_scatter_tensor(out, h, op=dist.ReduceOp.SUM, group=group)
        return self._to_device(out, x.device)

    def permute(self, x: torch.Tensor, perm, axes, *, async_op: bool = False):
        """JAX ``ppermute``: for each (src, dst) pair of group indices, element
        src's ``x`` goes to element dst.  A rank that receives nothing gets
        zeros; a pair (r, r) is a local copy.  With ``async_op`` the sends
        and receives are issued and a ``Pending`` is returned."""
        group, members = self._group(axes)
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if len(set(srcs)) < len(perm) or len(set(dsts)) < len(perm) or \
                not all(0 <= i < len(members) for i in srcs + dsts):
            raise ValueError(f"perm {perm} must send from and to each of the "
                             f"{len(members)} indices at most once")
        me = members.index(self.rank)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        works, ops, finish = [], [], (lambda: torch.zeros_like(x))
        if src == [me]:                  # the pair (me, me)
            finish = (lambda: x.clone())
        else:
            if dst:
                ops.append(dist.P2POp(dist.isend, self._to_host(x),
                                      dist.get_global_rank(group, dst[0]), group))
            if src:
                buf = self._host_buffer(x.shape, x)
                ops.append(dist.P2POp(dist.irecv, buf,
                                      dist.get_global_rank(group, src[0]), group))
                finish = (lambda: self._to_device(buf, x.device))
            if ops:
                works = dist.batch_isend_irecv(ops)
        pend = Pending(works, finish, ops)
        return pend if async_op else pend.wait()


# ---------------------------------------------------------------------------
class RecordingMesh(AbstractMesh):
    """One rank of a mesh with no processes behind it: the dry run's mesh,
    the counterpart of compiling for fake host devices.

    The rank sits at ``coords`` (default: the last coordinate on every axis,
    the rank whose end-aligned prefill rows see the most keys) and
    ``index`` is ``ProcessMesh``'s.  Every collective of ``ProcessMesh``
    has the same signature here and returns an empty ``meta`` tensor of the
    shape the real one returns; a one-rank group returns what
    ``ProcessMesh`` returns and is not tallied.  Each other call is tallied
    by op kind and group size p (``tally``, ``collective_stats``), with m
    the result's bytes on this rank and its wire bytes on a ring, as the
    JAX package's HLO analysis models them:

      all-reduce          2·m·(p−1)/p
      all-gather          m·(p−1)/p
      reduce-scatter      m·(p−1)
      all-to-all          m·(p−1)/p
      collective-permute  m
      broadcast           m  (every rank but the source receives m once;
                              a pipelined ring moves m over each link)

    ``staged_bytes`` counts, independently of ``ProcessMesh``'s code, what
    its host staging copies each way for this rank: an all-reduce or an
    all-to-all of x stages 2|x|, an all-gather (1 + p)|x|, a reduce-scatter
    |x| + |x|/p, a broadcast |x|, a permute |x| for each of sending and
    receiving (nothing for the pair (r, r)), a one-rank group nothing."""

    KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "broadcast")

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], coords=None):
        super().__init__(shape, axis_names)
        self.coords = tuple(int(c) for c in (coords if coords is not None
                                             else [s - 1 for s in self.shape]))
        if len(self.coords) != len(self.shape) or not all(
                0 <= c < s for c, s in zip(self.coords, self.shape)):
            raise ValueError(f"coords {self.coords} lie outside the mesh {self.shape}")
        self.rank = int(np.ravel_multi_index(self.coords, self.shape))
        self.staged_bytes = 0
        self.tally = {}                    # (kind, p) -> count, result and wire bytes

    index = ProcessMesh.index
    __enter__ = ProcessMesh.__enter__
    __exit__ = ProcessMesh.__exit__

    def _record(self, kind: str, p: int, shape, like: torch.Tensor, staged: int) -> torch.Tensor:
        m = math.prod(shape) * like.element_size()
        wire = {"all-reduce": 2.0 * m * (p - 1) / p, "all-gather": m * (p - 1) / p,
                "reduce-scatter": float(m * (p - 1)), "all-to-all": m * (p - 1) / p,
                "collective-permute": float(m), "broadcast": float(m)}[kind]
        t = self.tally.setdefault((kind, p), {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        t["count"] += 1
        t["result_bytes"] += m
        t["wire_bytes"] += wire
        self.staged_bytes += staged
        return torch.empty(tuple(shape), dtype=like.dtype, device="meta")

    def collective_stats(self) -> dict:
        """The tally in the JAX package's form (``per_op`` by kind, with
        ``broadcast`` added; totals) and by kind and group size."""
        per_op = {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0} for k in self.KINDS}
        by_group = {}
        for (kind, p), t in sorted(self.tally.items()):
            by_group[f"{kind}@{p}"] = dict(t)
            for key in t:
                per_op[kind][key] += t[key]
        return {"per_op": per_op, "by_group": by_group,
                "wire_bytes": sum(s["wire_bytes"] for s in per_op.values()),
                "result_bytes": sum(s["result_bytes"] for s in per_op.values())}

    # -- collectives -------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, op: str, axes) -> torch.Tensor:
        p = self.size(axes)
        if op not in ("sum", "min", "max"):
            raise ValueError(f"all_reduce op {op!r}")
        if p == 1:
            return x
        n = x.numel() * x.element_size()
        return self._record("all-reduce", p, x.shape, x, 2 * n)

    def broadcast(self, x: torch.Tensor, src: int, axes) -> torch.Tensor:
        p = self.size(axes)
        if p == 1:
            return x
        return self._record("broadcast", p, x.shape, x, x.numel() * x.element_size())

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        p = self.size(axes)
        if p == 1:
            return x[None]
        n = x.numel() * x.element_size()
        return self._record("all-gather", p, (p,) + tuple(x.shape), x, (1 + p) * n)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        p = self.size(axes)
        if p == 1:
            return x
        n = x.numel() * x.element_size()
        return self._record("all-to-all", p, x.shape, x, 2 * n)

    def reduce_scatter_sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        p = self.size(axes)
        if p == 1:
            return x
        if x.shape[0] % p:
            raise ValueError(f"leading dim {x.shape[0]} does not split {p} ways")
        n = x.numel() * x.element_size()
        return self._record("reduce-scatter", p, (x.shape[0] // p,) + tuple(x.shape[1:]), x,
                            n + n // p)

    def permute(self, x: torch.Tensor, perm, axes, *, async_op: bool = False):
        p = self.size(axes)
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if len(set(srcs)) < len(perm) or len(set(dsts)) < len(perm) or \
                not all(0 <= i < p for i in srcs + dsts):
            raise ValueError(f"perm {perm} must send from and to each of the "
                             f"{p} indices at most once")
        me = self.index(axes)
        if p == 1:
            out = x.clone() if (me, me) in perm else torch.zeros_like(x)
            pend = Pending([], lambda: out)
            return pend if async_op else pend.wait()
        n = x.numel() * x.element_size()
        sends = any(s == me and d != me for s, d in perm)
        receives = any(d == me and s != me for s, d in perm)
        out = self._record("collective-permute", p, x.shape, x, n if sends else 0)

        def finish():
            if receives:
                self.staged_bytes += n
            return out
        pend = Pending([], finish)
        return pend if async_op else pend.wait()


# ---------------------------------------------------------------------------
def local_block(x: torch.Tensor, spec, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's block of global ``x`` under ``spec``: a view, no copy."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split {n} ways "
                             f"over {axis!r}")
        blk = x.shape[d] // n
        x = x.narrow(d, mesh.index(axis) * blk, blk)
    return x


def assemble(x: torch.Tensor, spec, mesh: ProcessMesh) -> torch.Tensor:
    """The global value of local blocks ``x`` laid out by ``spec`` (the
    inverse of ``local_block``; an entry may name a tuple of axes, split
    row-major).  Axes the spec leaves out are replicated: each rank reads
    them at its own coordinate, so rank 0 reads coordinate 0."""
    parts = [() if a is None else (a if isinstance(a, tuple) else (a,)) for a in spec]
    named = {a for part in parts for a in part}
    axes = tuple(a for a in mesh.axis_names if a in named)
    if not axes:
        return x
    blocks = mesh.all_gather(x, axes)                     # (p_named, *x.shape)
    sizes = [mesh.size(a) for a in axes]
    out = x.new_empty(tuple(s * mesh.size(part) for s, part in
                            zip(x.shape, parts + [()] * (x.dim() - len(parts)))))
    for lin in range(blocks.shape[0]):
        at = dict(zip(axes, np.unravel_index(lin, sizes)))
        view = out
        for d, part in enumerate(parts):
            if part:
                i = 0
                for a in part:
                    i = i * mesh.size(a) + int(at[a])
                view = view.narrow(d, i * x.shape[d], x.shape[d])
        view.copy_(blocks[lin])
    return out


def spmd(body: Callable, mesh: ProcessMesh, in_specs, out_specs) -> Callable:
    """Run ``body`` as a FooPar SPMD program over ``mesh`` (the reference's
    ``dseq.spmd``).  Each global input is cut to this rank's block by its
    spec, ``body`` runs on the blocks with ``mesh`` active, and each output
    is assembled by its spec into the global value on every rank."""
    single_in = isinstance(in_specs, P)
    single_out = isinstance(out_specs, P)

    def run(*args):
        specs = (in_specs,) if single_in else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} inputs for {len(specs)} in_specs")
        with mesh:
            out = body(*(local_block(a, s, mesh) for a, s in zip(args, specs)))
            if single_out:
                return assemble(out, out_specs, mesh)
            return tuple(assemble(o, s, mesh) for o, s in zip(out, out_specs))

    return run


# ---------------------------------------------------------------------------
def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def _rank_main(rank, p, store_path, device, timeout_s, results, fn, args):
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)       # p ranks share the host's cores
        dist.init_process_group("gloo", store=dist.FileStore(store_path, p), rank=rank,
                                world_size=p, timeout=timedelta(seconds=timeout_s))
        try:
            out = _to_numpy(fn(device, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                  # reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(p: int, fn: Callable, *args, device: str = "cuda",
           timeout: float = 600.0) -> list:
    """Run ``fn(device, *args)`` on p gloo ranks and return their results in
    rank order (tensors come back as numpy arrays).

    The counterpart of ``--xla_force_host_platform_device_count``: p
    processes from the spawn start method (fork after CUDA init breaks),
    each on ``cuda:0`` unless ``device="cpu"``.  ``fn`` must be importable
    by name (a module-level function).  The process group and every
    collective time out after ``timeout`` seconds, and a rank that fails,
    dies or outlives the timeout fails the launch; every rank process is
    stopped before this returns."""
    dev = torch.device("cuda", 0) if device.startswith("cuda") else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch(device='cuda') needs a CUDA device; pass device='cpu' "
                           "for a CPU run")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, p, os.path.join(tmp, "store"), dev, timeout,
                                   results, fn, args)) for r in range(p)]
        for pr in procs:
            pr.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < p:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: ranks {sorted(set(range(p)) - set(got))} "
                                       f"gave no result within {timeout:g} s")
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, pr in enumerate(procs)
                            if r not in got and pr.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"launch: rank(s) {dead} died (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"launch: rank {rank} failed:\n{val}")
                got[rank] = val
            for pr in procs:
                pr.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.terminate()
                    pr.join(timeout=10)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
    return [got[r] for r in range(p)]
