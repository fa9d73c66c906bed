"""AdamW and the fused train step of the port, with the arithmetic of
``repro.train.optim`` op for op.

The optimizer state is f32 and shaped like the parameters, nested dicts as
they are.  Unlike the JAX package's pure update, ``adamw_update`` writes
the new moments and parameters in place, one piece of each leaf at a time
(``PIECE`` elements): the arithmetic is elementwise, so the numbers are
those of one expression per leaf, while the f32 temporaries stay the size
of a piece.  The JAX form would hold about five f32 temporaries of a whole
leaf: 3.8 GB each for h2o-danube-3-4b's stacked ``wi`` of 943.7 M
elements.

On a mesh of ranks (``train_step(..., rules)``) the parameters and the
moments are the rank's shards (``bridge.shard_train``) and AdamW runs on
them as they are; the gradients are first made whole sums over the ranks
that split the batch and, for a leaf that tensor parallelism leaves
whole, over its ``model`` ranks (and, of a leaf split by heads, the
positions every rank holds alike: Mamba2's B and C columns), and the clip
reads the global norm of the sharded gradients (``_sync_grads``,
``_sharded_norm``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import math

import torch

from repro_torch.core.collectives import all_reduce
from repro_torch.models import model as M
from repro_torch.models.sharding import Segments

#: elements of a leaf updated at once (64 MB of f32 per temporary)
PIECE = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # first moment  (f32, params-shaped)
    nu: Any               # second moment (f32, params-shaped)


def tree_paths(tree, path=()):
    """(key path, tensor) of every leaf of a nested dict, in
    ``jax.tree.leaves`` order (keys sorted at every level)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    for k in sorted(tree):
        yield from tree_paths(tree[k], path + (k,))


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in ``jax.tree.leaves`` order."""
    return [t for _, t in tree_paths(tree)]


def tree_unflatten(template, leaves) -> Any:
    """``leaves`` (in ``tree_leaves`` order) nested as ``template``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(template)


def _pieces(t: torch.Tensor):
    return t.reshape(-1).split(PIECE)


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])
    nu = tree_unflatten(params, [torch.zeros_like(m)
                                 for m in tree_leaves(zeros)])
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return AdamWState(step=step, mu=zeros, nu=nu)


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = None
    for g in tree_leaves(grads):
        s = sum(torch.sum(torch.square(piece.float()))
                for piece in _pieces(g))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _spec_leaves(specs) -> list:
    """``param_specs``' tuples in ``tree_leaves`` order."""
    if not isinstance(specs, dict):
        return [specs]
    return [t for k in sorted(specs) for t in _spec_leaves(specs[k])]


def _held_axes(spec) -> set:
    return {a for ax in spec if ax is not None
            for a in ((ax,) if isinstance(ax, str) else ax)}


def _summed_axes(rules) -> tuple:
    """The mesh axes over which a rank's gradient is a share of the whole
    one: the batch's (``act_batch``) and tensor parallelism's (each rank's
    share of a whole leaf's gradient: ``sharding.TensorParallel``)."""
    from repro_torch.models.sharding import tensor_parallel
    axes = rules.axis("act_batch")
    axes = set((axes,) if isinstance(axes, str) else tuple(axes or ()))
    tp = tensor_parallel(rules)
    if tp is not None:
        axes.add(tp.axis)
    return tuple(a for a in rules.mesh.axis_names if a in axes)


def _parts(spec, rules):
    """(dim, local positions or None for the whole leaf, the mesh axes
    that split it) of each part of a leaf of ``spec`` whose ranks hold it
    alike or apart: the leaf itself, or along a ``Segments`` dim its
    rank's own positions and those every rank of that axis holds alike."""
    held = _held_axes(spec)
    for d, ax in enumerate(spec):
        if isinstance(ax, Segments):
            shared = ax.shared(rules.axis_size(ax))
            own = sorted(set(range(ax.length(rules.axis_size(ax))))
                         - set(shared))
            return [(d, idx, h) for idx, h in ((own, held),
                                                (shared, held - {str(ax)}))
                    if idx]
    return [(None, None, held)]


def _index(idx, device):
    return torch.tensor(idx, dtype=torch.long, device=device)


def _part(g, d, idx):
    return g if idx is None else g.index_select(d, _index(idx, g.device))


@torch.no_grad()
def _sync_grads(grads, specs, rules) -> list:
    """Each rank's gradients made the global ones: a leaf's gradient is
    summed over the mesh axes that split the batch (``act_batch``) or
    run tensor parallelism and do not split the leaf (a leaf split over
    ``data`` had its sum over ``data`` from the reduce-scatter of its
    gather; one split over ``model`` is whole on its rank; of one split
    as ``Segments``, the positions every rank holds alike are summed over
    its axis too), in f32 and rounded once to its dtype; one collective
    for each set of axes."""
    summed = _summed_axes(rules)
    buckets = {}
    for i, spec in enumerate(specs):
        for d, idx, held in _parts(spec, rules):
            need = tuple(a for a in summed if a not in held)
            if need and rules.axis_size(need) > 1:
                buckets.setdefault(need, []).append((i, d, idx))
    grads = list(grads)
    for axes, parts in buckets.items():
        got = [_part(grads[i], d, idx) for i, d, idx in parts]
        flat = torch.cat([g.float().reshape(-1) for g in got])
        all_reduce(flat, "sum", rules.mesh.group(axes))
        for (i, d, idx), g, part in zip(parts, got,
                                        flat.split([g.numel() for g in got])):
            part = part.view(g.shape).to(g.dtype)
            grads[i] = part if idx is None else grads[i].index_copy(
                d, _index(idx, part.device), part)
    return grads


@torch.no_grad()
def _sharded_norm(grads, specs, rules) -> torch.Tensor:
    """The global norm of the whole gradients from the ranks' shards:
    each distinct shard counted once (a leaf's sum of squares over the
    number of ranks that hold the same block, a ``Segments`` leaf's
    positions held alike apart from its own), summed over the world."""
    world = rules.mesh.size
    total = None
    for g, spec in zip(grads, specs):
        for d, idx, held in _parts(spec, rules):
            share = math.prod(rules.axis_size(ax) for ax in held) / world
            s = sum(torch.sum(torch.square(piece.float()))
                    for piece in _pieces(_part(g, d, idx))) * share
            total = s if total is None else total + s
    return torch.sqrt(all_reduce(total, "sum", None))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 gnorm=None):
    """One AdamW step with global-norm clipping, in place on ``params``
    and ``state``'s moments.  ``gnorm``: the gradients' global norm where
    the caller has it (sharded gradients), else taken here.  Returns
    (params, AdamWState with the new step, the gradients' global norm)."""
    if gnorm is None:
        gnorm = _global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        for pp, gp, mp, vp in zip(_pieces(p), _pieces(g), _pieces(m),
                                  _pieces(v)):
            gf = gp.float() * scale
            vp.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
            mp.mul_(b1).add_(gf.mul_(1 - b1))
            update = (mp / c1).div_(torch.sqrt(vp / c2).add_(eps))
            pf = pp.float()
            update.add_(weight_decay * pf)
            pp.copy_(pf - lr * update)
    return params, AdamWState(step, state.mu, state.nu), gnorm


def train_step(params, opt_state: AdamWState, batch, cfg, rules=None,
               lr: float = 3e-4):
    """One fused loss + grad + AdamW step, as the JAX package's
    ``train_step``.  The parameters require grad only inside the step:
    ``torch.autograd.grad`` returns the gradients without storing them on
    the leaves.  ``batch``: tensors on the parameters' device (tokens,
    labels, positions).  ``rules``: a rank of a mesh, ``params`` and
    ``opt_state`` its shards, ``batch`` the global batch (every rank the
    same; ``loss_fn`` takes the rank's rows).  Returns (params, opt_state,
    metrics: loss, nll, aux, grad_norm as 0-dim tensors, global on a mesh
    too); params and opt_state are updated in place."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = M.loss_fn(params, batch, cfg, rules)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    gnorm = None
    if rules is not None:
        specs = _spec_leaves(M.param_specs(cfg, rules))
        grads = _sync_grads(grads, specs, rules)
        gnorm = _sharded_norm(grads, specs, rules)
    params, opt_state, gnorm = adamw_update(
        params, tree_unflatten(params, grads), opt_state, lr=float(lr),
        gnorm=gnorm)
    metrics = {"loss": loss.detach(),
               **{k: t.detach() for k, t in metrics.items()},
               "grad_norm": gnorm}
    return params, opt_state, metrics
