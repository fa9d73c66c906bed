"""Meshes of ranks, sharding-rule construction, and a launcher of ranks.

The JAX package's mesh is one program over many devices
(``jax.make_mesh``).  The port's ranks are processes, one per device,
joined by ``torch.distributed``; a :class:`Mesh` gives them the same named
axes, each rank's coordinates row-major as ``jax.make_mesh`` orders its
devices, and one process group for each set of axes that the rules name.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the pod axis is pure
data parallelism (batch + KV pool blocks shard over it).

:func:`launch` runs a function on N ranks of this host:
    launch(fn, 2)                         # gloo, on the CPU or one card
    launch(fn, 2, backend="nccl")         # one card per rank
A command line started once per rank by another launcher (``torchrun``,
a cluster's) joins its world with :func:`init_world` from the
environment.
"""
from __future__ import annotations

import itertools
import math
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.models.sharding import DEFAULT_RULES, ShardingRules


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over the ranks of the default process group (or, with
    ``rank=None`` and no process group, over none: a shape to reason
    about, as JAX's ``AbstractMesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: Optional[int] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} against axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        if rank is None and dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != self.size:
                raise ValueError(f"a mesh of {self.size} ranks in a world "
                                 f"of {dist.get_world_size()}")
            rank = dist.get_rank()
        self.rank = rank
        self.coords = None if rank is None else self.coords_of(rank)
        self._groups = {}

    def coords_of(self, rank: int) -> dict:
        """A rank's coordinate on each axis, the last axis fastest."""
        coords = {}
        for a in reversed(self.axis_names):
            rank, coords[a] = divmod(rank, self.shape[a])
        return {a: coords[a] for a in self.axis_names}

    def _index(self, coords: dict, axes) -> int:
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple of names),
        row-major over them in the order given, as the JAX package's
        decode counts its shard: ``idx = idx * size(a) + axis_index(a)``."""
        return self._index(self.coords, axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def _members(self, axes):
        """Every group of ranks that differ only along ``axes``, each by
        index along ``axes``; the groups in the order of the other axes."""
        axes = _axes(axes)
        groups = {}
        for r in range(self.size):
            c = self.coords_of(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            groups.setdefault(key, []).append((self._index(c, axes), r))
        return [[r for _, r in sorted(g)] for _, g in sorted(groups.items())]

    def make_groups(self, axes) -> None:
        """Create the process groups along ``axes``.  Every rank must call
        this for the same axes in the same order (``dist.new_group`` is
        collective over the whole world)."""
        key = _axes(axes)
        if key in self._groups or self.rank is None:
            return
        for members in self._members(key):
            pg = dist.new_group(members)
            if self.rank in members:
                self._groups[key] = (pg, members)

    def group(self, axes):
        """This rank's process group along ``axes``."""
        try:
            return self._groups[_axes(axes)][0]
        except KeyError:
            raise KeyError(f"no process group along {_axes(axes)}: build "
                           f"the rules with make_rules") from None

    def group_order(self, axes) -> list:
        """The global ranks of :meth:`group`, by index along ``axes``."""
        return list(self._groups[_axes(axes)][1])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (data 16, model 16) mesh, or (pod 2, data 16, model 16), over a
    world of 256 or 512 ranks; raises in any other world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                           f"production mesh needs {need} ranks; the world "
                           f"has {world}")
    return Mesh(shape, axes)


def make_rules(mesh: Mesh, *, kv_axes: Optional[tuple] = None
               ) -> ShardingRules:
    """Logical->physical rules for the given mesh (pod-aware).  On a mesh
    of ranks it creates the process groups of every set of axes that the
    rules name and of every set of mesh axes in mesh order (a training
    step sums a leaf's gradient over the batch's and tensor parallelism's
    axes that do not split it), in the same order on every rank."""
    rules = dict(DEFAULT_RULES)
    multi_pod = "pod" in mesh.shape
    if multi_pod:
        rules["act_batch"] = ("pod", "data")
        rules["kv_blocks"] = ("pod", "data", "model")
    if kv_axes is not None:
        rules["kv_blocks"] = kv_axes
    every = {c for n in range(1, len(mesh.axis_names) + 1)
             for c in itertools.combinations(mesh.axis_names, n)}
    for axes in sorted({_axes(v) for v in rules.values() if v is not None}
                       | every):
        mesh.make_groups(axes)
    return ShardingRules(mesh=mesh, rules=rules)


def total_shards(rules: ShardingRules, logical: str = "kv_blocks") -> int:
    return rules.axis_size(rules.axis(logical))


def init_world(backend: Optional[str] = None) -> int:
    """Join the default process group from the environment a launcher
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) where
    it names a world of more than one rank and none is joined yet; the
    backend NCCL with cards (each rank on card ``LOCAL_RANK``, else
    ``RANK`` modulo the cards), else gloo.  Returns the world's size (1
    where there is none)."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    return world


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, nprocs, backend, rendezvous, args, results):
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                world_size=nprocs, rank=rank)
        # every rank's connections up before any rank may run ahead, return
        # and close its own: gloo's peers are otherwise left mid-handshake
        # ("Connection closed by peer") when one rank's ``fn`` is quick
        dist.barrier()
        try:
            out = fn(rank, nprocs, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:               # reported, then the rank exits 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def launch(fn, nprocs: int, args=(), *, backend: str = "gloo",
           timeout: float = 300.0):
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` ranks of this host, one
    process each (started with ``spawn``: a forked child cannot use CUDA),
    joined in a default process group of ``backend`` that meets at a
    ``file://`` rendezvous in a fresh temporary directory (no TCP port to
    clash).  ``fn`` must be importable by name and return picklable values
    (numpy, Python, CPU tensors).  Returns the ranks' results in rank order.
    The first failure a rank reports is raised here, with its traceback;
    a rank that dies unreported, or a run past ``timeout`` seconds, raises
    too, and every rank still running is then stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nprocs, backend, rendezvous, args,
                                   results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        got, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(got) < nprocs and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = f"ranks {sorted(set(range(nprocs)) - set(got))}" \
                        f" did not finish within {timeout:.0f} s"
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        # give a failing rank's report a moment to arrive
                        try:
                            rank, ok, out = results.get(timeout=5.0)
                        except queue_mod.Empty:
                            failure = (f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                            break
                    else:
                        continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(nprocs)]


__all__ = ["Mesh", "make_production_mesh", "make_rules", "total_shards",
           "init_world", "launch"]
