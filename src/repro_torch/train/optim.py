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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import model as M

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


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step with global-norm clipping, in place on ``params``
    and ``state``'s moments.  Returns (params, AdamWState with the new
    step, the gradients' global norm)."""
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


def train_step(params, opt_state: AdamWState, batch, cfg, lr: float = 3e-4):
    """One fused loss + grad + AdamW step, as the JAX package's
    ``train_step``.  The parameters require grad only inside the step:
    ``torch.autograd.grad`` returns the gradients without storing them on
    the leaves.  ``batch``: tensors on the parameters' device (tokens,
    labels, positions).  Returns (params, opt_state, metrics: loss, nll,
    aux, grad_norm as 0-dim tensors); params and opt_state are updated in
    place."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = M.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
    params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                            lr=float(lr))
    metrics = {k: t.detach() for k, t in metrics.items()}
    metrics.update(loss=loss.detach(), grad_norm=gnorm)
    return params, opt_state, metrics
