"""What a rank's program does, counted while it runs once: the port's
counterpart of the JAX package's ``repro/launch/hlo_analysis.py``.

The JAX package reads its dry run's quantities from compiled HLO.  Eager
PyTorch has no HLO, so the name says what this module reads instead: the
ops the program issues.  ``count(fn, args)`` runs ``fn(*args)`` under an
:class:`OpCounter`, a ``TorchDispatchMode`` that sees every ``aten`` op,
and returns an :class:`OpCount`:

  * ``dot_flops``  -- the matrix products' flops, by
    ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolutions);
  * ``hbm_bytes``  -- each op's operand and result bytes: eager PyTorch
    fuses nothing, so this is what it moves.  Views, allocations and
    other ops that move no data count zero (``hlo_analysis._NO_TRAFFIC``);
    a gather of rows counts the rows it reads, an in-place scatter the
    rows it writes, not the whole table;
  * ``kernels``    -- each hand-written kernel's calls and its cost
    function's flops and bytes, reported by its wrapper
    (``kernels.kernel_call``) and kept beside the ``aten`` counts, never
    in them: the ops inside a wrapper (its plain version on the CPU)
    are not counted;
  * ``collectives``-- calls and bytes by kind on the ring model, read
    from ``core.collectives.stats``, which counts the same way in a real
    run and a dry one;
  * ``mem``        -- the peak of live storage bytes, split as XLA's
    ``memory_analysis()`` splits it: arguments, outputs, temporaries and
    outputs aliased to arguments (updated in place).

The port's layer loops are Python loops that run every layer, so no trip
count is needed.  On ``meta`` tensors the program allocates and computes
nothing; on real tensors the same counts come from a real run.
"""
from __future__ import annotations

import gc
import sys
import weakref
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.utils.checkpoint
import torch.utils.flop_counter as _flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import collectives

aten = torch.ops.aten

#: ops that move no data of their own (besides views): allocations without
#: a fill, scalar reads, metadata
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._local_scalar_dense.default,
               aten.lift_fresh.default, aten.detach.default,
               aten.alias.default}

#: ops that read only the rows they produce (the JAX analysis' slicing
#: ops): charged their output read and written, and their indices
_SLICING = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
            aten.embedding.default}

#: in-place updates of some rows of their first operand: charged the
#: update read and written, and the indices, not the whole operand
_UPDATING = {aten.index_put_.default, aten._index_put_impl_.default,
             aten.scatter_.src, aten.scatter_.value, aten.scatter_add_.default,
             aten.scatter_reduce_.two, aten.index_add_.default,
             aten.index_copy_.default}

#: in-place ops that write their first operand without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}

_HERE = __file__
#: the file whose frame calls autograd's engine
_ENGINE = "torch/autograd/graph.py"
#: the file of ``torch.distributed``'s collectives
_C10D = "torch/distributed/distributed_c10d.py"
_INSIDE_COLLECTIVE = "(inside a collective)"


def _tensors(tree):
    """Every tensor of a nest of lists, tuples (NamedTuples too) and
    dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """The innermost function of the port on the Python stack (module and
    name); ``backward`` where autograd's engine issued the op for a node
    of the graph (no port function on the stack above the engine's
    entry; the node's name is not read: reading it makes the node's
    Python wrapper, which the node then holds, a reference cycle for each
    node read, and a long graph's chain of them, freed by the cyclic
    collector, is freed one node inside the next, past the stack's
    depth); ``_INSIDE_COLLECTIVE`` where
    ``torch.distributed`` issued it inside a collective (a backend's own
    staging, gloo's reduce-scatter, say: link traffic, not counted as an
    ``aten`` op's)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.endswith(_C10D):
            return _INSIDE_COLLECTIVE
        if path.endswith(_ENGINE):
            return "backward"
        if "repro_torch" in path and path != _HERE:
            mod = f.f_globals.get("__name__", "?").replace("repro_torch.", "")
            return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


def _shapes(x):
    """``x`` with every tensor replaced by its shape (lists and tuples
    walked)."""
    if isinstance(x, torch.Tensor):
        return x.shape
    if isinstance(x, (list, tuple)):
        return type(x)(_shapes(v) for v in x)
    return x


def _flops(func, args, kwargs, out) -> float:
    """``torch.utils.flop_counter``'s count of one op (0 for an op it has
    no formula for).  The formula is called on the operands' shapes
    directly: its own wrapper maps them with ``pytree``, whose closures
    hold the operands in reference cycles that only the cyclic collector
    frees, which would move the peak of live storages."""
    formula = _flop_counter.flop_registry.get(func._overloadpacket)
    if formula is None:
        return 0
    raw = getattr(formula, "__wrapped__", None)
    if raw is None:
        return formula(*args, **kwargs, out_val=out)
    return raw(*_shapes(args), out_shape=_shapes(out),
               **{k: _shapes(v) for k, v in kwargs.items()})


def _traffic(func, args, kwargs, out) -> float:
    """HBM bytes one ``aten`` op moves (module docstring)."""
    if func in _NO_TRAFFIC or func.is_view:
        return 0.0
    ins = list(_tensors(args)) + list(_tensors(kwargs))
    outs = list(_tensors(out))
    if func in _SLICING:
        idx = [t for t in ins[1:] if not t.is_floating_point()]
        return 2.0 * sum(map(_nbytes, outs)) + sum(map(_nbytes, idx))
    if func in _UPDATING:
        return 2.0 * sum(map(_nbytes, ins[1:]))
    if func in _WRITE_ONLY:
        ins = ins[1:]
    return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))


@dataclass
class OpCount:
    """One run's counts (module docstring).  ``ops``: (aten op, the port
    function that issued it) -> [calls, flops, bytes]; ``kernels``: name
    -> {"launches", "flops", "bytes", "dtype"}; ``collectives``: kind ->
    {"calls", "bytes"} and ``collective_sites``: (c10d op, port function)
    -> [calls, operand bytes]; ``mem``: the XLA-style split in bytes."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    ops: Dict[Tuple[str, str], list] = field(default_factory=dict)
    kernels: Dict[str, dict] = field(default_factory=dict)
    collectives: Dict[str, dict] = field(default_factory=dict)
    collective_sites: Dict[Tuple[str, str], list] = field(
        default_factory=dict)
    mem: Dict[str, int] = field(default_factory=dict)

    @property
    def kernel_flops(self) -> float:
        return float(sum(k["flops"] for k in self.kernels.values()))

    @property
    def kernel_bytes(self) -> float:
        return float(sum(k["bytes"] for k in self.kernels.values()))

    @property
    def collective_bytes(self) -> float:
        return float(sum(c["bytes"] for c in self.collectives.values()))

    @property
    def collective_calls(self) -> int:
        return int(sum(c["calls"] for c in self.collectives.values()))

    def launches(self) -> Dict[str, int]:
        return {k: v["launches"] for k, v in self.kernels.items()}


class OpCounter(TorchDispatchMode):
    """Counts the ops of the code run under it into ``self.result`` (an
    :class:`OpCount`), and tracks the live storages: those of the
    arguments given to :meth:`hold` and of every op's results.  With
    ``gloo``, a reduce-scatter also holds a copy of its operand on the
    operand's device while it runs, as ``ProcessGroupGloo`` does (it
    all-reduces a clone and keeps its chunk of it); NCCL, whose ranks the
    dry run models, holds none."""

    def __init__(self, gloo: bool = False):
        super().__init__()
        self.gloo = gloo
        self.result = OpCount()
        self._ops = defaultdict(lambda: [0, 0.0, 0.0])
        self._colls = defaultdict(lambda: [0, 0.0])
        self._inside = 0
        self._live: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- memory ------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def hold(self, args) -> None:
        """Track the storages of ``args`` (the run's arguments) as live."""
        for t in _tensors(args):
            self._track(t)
            st = t.untyped_storage()
            self._args[st._cdata] = st.nbytes()

    def split(self, result) -> Dict[str, int]:
        """The peak's split (XLA's ``memory_analysis()``): arguments,
        outputs (every distinct storage of ``result``), of those the ones
        aliased to an argument, and the temporaries: the rest of the
        peak, so that arguments + outputs + temporaries - aliased is the
        peak of live bytes."""
        out = {}
        for t in _tensors(result):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
        arg = sum(self._args.values())
        alias = sum(n for k, n in out.items() if k in self._args)
        output = sum(out.values())
        total = max(self.peak_bytes, arg + output - alias)
        return dict(argument_bytes=arg, output_bytes=output,
                    alias_bytes=alias,
                    temp_bytes=total - arg - output + alias,
                    total_bytes=total)

    # -- kernels -----------------------------------------------------------

    def kernel_launch(self, name: str, cost) -> None:
        k = self.result.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0,
                   "dtype": str(cost.dtype).replace("torch.", "")})
        k["launches"] += 1
        k["flops"] += float(cost.flops)
        k["bytes"] += float(cost.nbytes)

    @contextmanager
    def inside_kernel(self):
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        if func.namespace == "c10d":
            row = self._colls[(func._overloadpacket.__name__, _site())]
            row[0] += 1
            row[1] += sum(map(_nbytes, _tensors(args)))
            if self.gloo and "reduce_scatter" in func.__name__:
                self.peak_bytes = max(self.peak_bytes, self.live_bytes + max(
                    map(_nbytes, _tensors(args))))
            return out
        if self._inside:
            return out
        self._count(func, args, kwargs, out, _site())
        return out

    def count_as(self, func, args, kwargs, out) -> None:
        """Count ``func`` on ``args`` with output ``out`` as though it had
        been dispatched here: a device's stand-in for an op it lacks (the
        CPU's for a bf16 product with an f32 output), whose own ops ran
        inside :meth:`inside_kernel`."""
        if not self._inside:
            self._count(func, args, kwargs, out, _site())

    def _count(self, func, args, kwargs, out, site) -> None:
        if site == _INSIDE_COLLECTIVE:
            return
        flops = _flops(func, args, kwargs, out)
        nbytes = _traffic(func, args, kwargs, out)
        self.result.dot_flops += flops
        self.result.hbm_bytes += nbytes
        row = self._ops[(str(func._overloadpacket).replace("aten.", ""),
                         site)]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def finish(self, result) -> OpCount:
        self.result.ops = {k: list(v) for k, v in self._ops.items()}
        self.result.collective_sites = {k: list(v)
                                        for k, v in self._colls.items()}
        self.result.mem = self.split(result)
        return self.result


def _collective_snapshot() -> Dict[str, dict]:
    return {k: {"calls": collectives.stats["calls_by_kind"][k],
                "bytes": collectives.stats["bytes"][k]}
            for k in collectives.KINDS}


_warmed = False


def _warm_lazy_imports() -> None:
    """One tiny checkpointed backward, once a process: the first such call
    imports modules lazily (``torch._dynamo``), and exceptions caught on
    the way keep their tracebacks, whose frames reach back into the caller
    and hold its tensors in reference cycles; counted, with the collector
    off, they would stay live to the run's end (a training step's peak
    too high where its first checkpointed block came inside the count)."""
    global _warmed
    if _warmed:
        return
    with torch.enable_grad():       # a count may start under no_grad
        x = torch.ones(2, requires_grad=True)
        torch.utils.checkpoint.checkpoint(
            torch.sin, x, use_reentrant=False,
            preserve_rng_state=False).sum().backward()
    gc.collect()
    _warmed = True


def count(fn, args=(), gloo: bool = False) -> Tuple[object, OpCount]:
    """Run ``fn(*args)`` once under an :class:`OpCounter` (``gloo``: its
    peak as a rank of a gloo group holds it), the storages of ``args``
    held as the arguments.  Returns (its result, the counts).  The cyclic
    garbage collector is off meanwhile, so that the peak does not depend
    on when it runs: a storage lives until its last reference goes (the
    port's step leaves no reference cycle holding a tensor, once
    ``_warm_lazy_imports`` has run)."""
    _warm_lazy_imports()
    counter = OpCounter(gloo)
    counter.hold(args)
    before = _collective_snapshot()
    was_on = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with counter:
            result = fn(*args)
    finally:
        if was_on:
            gc.enable()
    after = _collective_snapshot()
    counter.result.collectives = {
        k: {"calls": after[k]["calls"] - before[k]["calls"],
            "bytes": after[k]["bytes"] - before[k]["bytes"]}
        for k in collectives.KINDS}
    return result, counter.finish(result)


__all__ = ["OpCount", "OpCounter", "count"]
