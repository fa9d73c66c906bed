"""The collectives of the port's multi-rank paths (``torch.distributed``).

The JAX package's sharded decode calls ``pmax``/``psum`` inside
``shard_map``; the port's ranks are processes, and these helpers are what
they call in their place.  A CUDA tensor goes to the backend as it is:
NCCL reduces it on the cards; gloo (two ranks on one card, where NCCL
refuses) takes it too and stages it through the host itself
(``tools/probe_gloo_cuda.py`` checks that, and times both ways).

``stats`` holds the calls made and the host seconds spent inside them
since the caller last reset it; a call returns once its result is there
(gloo), or once it is queued on the stream (NCCL).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "stats", "reset_stats"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

stats = {"calls": 0, "seconds": 0.0}


def reset_stats() -> None:
    stats.update(calls=0, seconds=0.0)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced (``op``: "sum" or "max") over the ranks of ``group``
    (None: all of them), in place; returns ``t``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, _OPS[op], group=group)
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return t


def all_gather(t: torch.Tensor, group, order) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along dim 0, the rank
    at ``order[i]`` (a global rank) i-th."""
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    # parts come in the group's rank order: its global ranks, sorted
    by_rank = dict(zip(sorted(order), parts))
    out = torch.cat([by_rank[r] for r in order])
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return out
