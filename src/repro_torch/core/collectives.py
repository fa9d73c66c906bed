"""The collectives of the port's multi-rank paths (``torch.distributed``).

The JAX package calls ``pmax``/``psum``/``all_gather``/``psum_scatter``
inside ``shard_map`` (and GSPMD inserts more); the port's ranks are
processes, and these helpers are what they call in their place.  A CUDA
tensor goes to the backend as it is: NCCL reduces it on the cards; gloo
(ranks sharing one card, where NCCL refuses) takes it too and stages it
through the host itself (``tools/probe_gloo_cuda.py`` checks that, the
training collectives included, and times them).

Two kinds:
- plain (``all_reduce``, ``all_gather``): outside autograd, for what
  carries no gradient (the decode step's merge, counts, metrics).  Called
  in grad mode on a tensor that requires grad they raise, as a kernel
  without a backward does (``kernels.refuse_grad``): their result would
  cut the gradient silently.
- differentiable (``torch.autograd.Function``), each the transpose of its
  mirror as JAX's ``shard_map`` transposes them: ``sum_over`` (the sum over
  a group of a value every rank then holds: backward the identity, JAX's
  ``psum`` into an output replicated over the axis), ``sum_grad_over``
  (the identity, backward the cotangent summed over the group: an input
  replicated over the axis that each rank consumes its own way),
  ``gather_over`` (``all_gather(tiled=True)`` along a dim: backward
  ``reduce_scatter``) and ``reduce_scatter`` (``psum_scatter(tiled=True)``:
  backward ``gather_over``).  Sums run in f32 and round once to the
  operand's dtype (XLA's reduction of a bf16 value across devices).

A group's chunks follow its ranks' order in the group (global ranks
sorted), which is the index along the mesh axis for every group
``launch.mesh.Mesh`` builds of one axis.  A group of one rank is no
collective: the helpers return their operand.

``stats`` holds the calls made and the host seconds spent inside them
since the caller last reset it (and, under :func:`tagged`, those of one
tag apart: tensor parallelism's, ``"tensor-parallel"``); a call returns once its result is there
(gloo), or once it is queued on the stream (NCCL).  It also holds each
kind's calls (``calls_by_kind``) and the bytes a rank moves through its
links for them (``bytes``) on the ring model of the JAX package's dry
run: an all-gather or a reduce-scatter moves (g - 1) / g of the whole
buffer, an all-reduce twice that, over a group of g ranks.  The dry run
(``launch.op_analysis``) reads the same numbers from a rank's program run
on ``meta`` tensors under a fake process group.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "sum_over", "sum_grad_over",
           "gather_over", "reduce_scatter", "stats", "reset_stats", "tagged",
           "KINDS", "TENSOR_PARALLEL"]

#: the tag of tensor parallelism's collectives
TENSOR_PARALLEL = "tensor-parallel"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

#: the collectives' kinds, by the names of the JAX package's HLO
KINDS = ("all-reduce", "all-gather", "reduce-scatter")

stats = {"calls": 0, "seconds": 0.0, "calls_by_kind": dict.fromkeys(KINDS, 0),
         "bytes": dict.fromkeys(KINDS, 0.0), "tagged": {}}

#: the tag that the collectives called now count under (``tagged``)
_tag = [None]

# one reduce-scatter into one tensor: ``reduce_scatter_tensor`` was renamed
# ``reduce_scatter_single`` (the old name warns in newer torch builds)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 getattr(dist, "reduce_scatter_tensor", None))


def reset_stats() -> None:
    stats.update(calls=0, seconds=0.0,
                 calls_by_kind=dict.fromkeys(KINDS, 0),
                 bytes=dict.fromkeys(KINDS, 0.0), tagged={})


@contextlib.contextmanager
def tagged(tag: str):
    """Inside: each collective called (and the backward of each
    differentiable one called here) counts its call and host seconds
    under ``stats["tagged"][tag]`` too, as [calls, seconds]."""
    prev, _tag[0] = _tag[0], tag
    try:
        yield
    finally:
        _tag[0] = prev


class _Timed:
    """Counts one collective call of ``kind`` over ``group`` on a buffer
    of ``whole`` bytes (the whole one: the gathered result, the scattered
    operand), the bytes it moves and the host seconds inside it."""

    def __init__(self, kind: str, whole: int, group):
        g = _size(group)
        self.kind = kind
        self.moved = whole * (g - 1) / g * (2 if kind == "all-reduce" else 1)

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stats["calls"] += 1
        stats["seconds"] += dt
        stats["calls_by_kind"][self.kind] += 1
        stats["bytes"][self.kind] += self.moved
        if _tag[0] is not None:
            got = stats["tagged"].setdefault(_tag[0], [0, 0.0])
            got[0] += 1
            got[1] += dt


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _refuse_grad(what: str, t: torch.Tensor) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(
            f"{what}: a plain collective cuts the gradient; call it under "
            f"torch.no_grad() or use sum_over, sum_grad_over, gather_over "
            f"or reduce_scatter")


def _size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced (``op``: "sum" or "max") over the ranks of ``group``
    (None: all of them), in place; returns ``t``."""
    _refuse_grad("all_reduce", t)
    with _Timed("all-reduce", _nbytes(t), group):
        dist.all_reduce(t, _OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group, order) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along dim 0, the rank
    at ``order[i]`` (a global rank) i-th."""
    _refuse_grad("all_gather", t)
    with _Timed("all-gather", _nbytes(t) * _size(group), group):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(_size(group))]
        dist.all_gather(parts, t, group=group)
        # parts come in the group's rank order: its global ranks, sorted
        by_rank = dict(zip(sorted(order), parts))
        out = torch.cat([by_rank[r] for r in order])
    return out


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in f32, rounded once to its dtype."""
    f = t.float().contiguous()
    if f is t:
        f = f.clone()                      # never sum into the operand
    with _Timed("all-reduce", _nbytes(f), group):
        dist.all_reduce(f, dist.ReduceOp.SUM, group=group)
    return f.to(t.dtype)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum_f32(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.tag = group, _tag[0]
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with tagged(ctx.tag):
            return _sum_f32(g, ctx.group), None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (f32, rounded once),
    the same on each; the gradient passes back unchanged (each rank's
    cotangent of the sum is the whole one)."""
    if _size(group) == 1:
        return t
    return _SumOver.apply(t, group)


def sum_grad_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; its gradient is the cotangents of every rank of
    ``group`` summed (f32, rounded once): ``t`` is the same on each rank
    and each consumes it with its own share of the work."""
    if _size(group) == 1:
        return t
    return _SumGradOver.apply(t, group)


def _chunk_shape(t, d, n):
    return t.shape[:d] + (t.shape[d] // n,) + t.shape[d + 1:]


def _gather(tensors, dims, group):
    """Every rank's ``tensors`` concatenated, each along its dim, in the
    group's rank order: one collective of the shards laid end to end,
    each result contiguous."""
    n = _size(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with _Timed("all-gather", _nbytes(flat) * n, group):
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
    out, at = [], 0
    for t, d in zip(tensors, dims):
        k = t.numel()
        out.append(torch.cat([part[at:at + k].view(t.shape)
                              for part in parts], dim=d))
        at += k
    return out


def _reduce_scatter(tensors, dims, group):
    """Each tensor summed over ``group`` in f32 (rounded once to its
    dtype), this rank's chunk along its dim kept; one collective of the
    rank-r chunks of every tensor laid end to end, r by r."""
    n = _size(group)
    dtype = tensors[0].dtype
    flat = torch.cat([t.narrow(d, r * (t.shape[d] // n), t.shape[d] // n)
                      .float().reshape(-1)
                      for r in range(n) for t, d in zip(tensors, dims)])
    out = torch.empty((flat.numel() // n,), dtype=torch.float32,
                      device=flat.device)
    with _Timed("reduce-scatter", _nbytes(flat), group):
        _reduce_scatter_single(out, flat, dist.ReduceOp.SUM, group=group)
    res, at = [], 0
    for t, d in zip(tensors, dims):
        shape = _chunk_shape(t, d, n)
        k = t.numel() // n
        res.append(out[at:at + k].view(shape).to(dtype))
        at += k
    return res


def _check_one_dtype(tensors):
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("one collective moves tensors of one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, *tensors):
        ctx.group, ctx.dims, ctx.tag = group, dims, _tag[0]
        return tuple(_gather(tensors, dims, group))

    @staticmethod
    def backward(ctx, *gs):
        with tagged(ctx.tag):
            return (None, None, *_reduce_scatter(gs, ctx.dims, ctx.group))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, *tensors):
        ctx.group, ctx.dims, ctx.tag = group, dims, _tag[0]
        return tuple(_reduce_scatter(tensors, dims, group))

    @staticmethod
    def backward(ctx, *gs):
        with tagged(ctx.tag):
            return (None, None, *_gather(gs, ctx.dims, ctx.group))


def gather_over(tensors, dims, group) -> list:
    """Every rank's ``tensors`` of ``group`` concatenated, each along its
    dim of ``dims``, in the group's rank order (JAX's ``all_gather(...,
    tiled=True)``), in one collective; their gradient is the cotangents
    reduce-scattered back (:func:`reduce_scatter`).  ``tensors``: a list of
    one dtype."""
    tensors, dims = list(tensors), tuple(dims)
    _check_one_dtype(tensors)
    if _size(group) == 1:
        return tensors
    return list(_GatherOver.apply(group, dims, *tensors))


def reduce_scatter(tensors, dims, group) -> list:
    """Each of ``tensors`` summed over ``group`` (f32, rounded once), this
    rank's chunk along its dim of ``dims`` kept (JAX's
    ``psum_scatter(..., tiled=True)``), in one collective; the gradient is
    the cotangents gathered back (:func:`gather_over`)."""
    tensors, dims = list(tensors), tuple(dims)
    _check_one_dtype(tensors)
    if _size(group) == 1:
        return tensors
    return list(_ReduceScatter.apply(group, dims, *tensors))
