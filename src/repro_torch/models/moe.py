"""Mixture-of-experts layer with capacity-based sort dispatch: the unsharded
path of ``repro.models.moe``.

Tokens are routed to their top-k experts, sorted by expert id (a stable
sort), ranked within their expert's segment and placed into an (E, C, d)
dispatch buffer; a token beyond an expert's capacity C is dropped.  The
expert FFN runs on the buffer (kernel K7 on the card) and the outputs are
combined back per token with the gate weights.  Everything stays on the
device: ``capacity`` is a Python int from static shapes, and no step reads
a value back to the host.

Training: with grad on, the expert FFN's gradient comes from K7's backward
kernels on the card (``moe_ffn`` takes its autograd Function), the rest of
the layer's from autograd.  Under ``torch.utils.checkpoint`` the layer runs
again in the backward pass, and the recompute must route as the pass did:
the router's stable sort, the dispatch's stable argsort and
``searchsorted``, and the combine's fixed order are deterministic ops on
the same inputs, so it does, bit for bit.  The dispatch gather and the
combine are each other's gradient (:class:`_DispatchGather`,
:class:`_SumSlots`): each token sums its own ``top_k`` slots' rows in a
fixed order, and each slot takes its one token's row; no atomics.

Expert parallelism (``rules`` naming a mesh of ranks, the JAX package's
``_moe_layer_local``): each rank routes its own share of the batch rows,
fills the dispatch slots of the experts it holds, runs their FFN (K7 over
the rank's experts alone), and the ranks' combined rows are summed over the
expert axis (:func:`_expert_parallel`, one core for both passes).  Decode gathers the rows back over the batch axis; a training
pass (``local_rows``) hands the layer its own rows and keeps them, gathers
the FSDP shards of the weights over ``data`` inside the layer, and its
gradient crosses the collectives (``core.collectives``' differentiable
ones).  Under tensor parallelism over the experts' axis (the default
rules) a training pass hands the experts' partial sums to the residual's
reduce-scatter (``sharding.TensorParallel.out``) and leaves the rows' and
the gate weights' gradients each rank's share; the shared expert runs
tensor-parallel, the router whole.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import all_gather, sum_grad_over, sum_over
from repro_torch.kernels.moe_ffn.ops import moe_ffn
from repro_torch.models.layers import mlp
from repro_torch.models.params import moe_schema
from repro_torch.models.sharding import gather_fsdp, train_spec


def router_topk(logits, top_k: int):
    """Top-k routing with softmax-renormalised gate weights.

    logits: (t, E) f32.  Returns (weights (t, k), ids (t, k) int32,
    probs (t, E)).  Among equal probabilities the lower expert id comes
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order, so a stable descending sort takes its place)."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids.to(torch.int32), probs


def load_balance_loss(probs, ids, num_experts: int):
    """Switch-style auxiliary loss: E * sum_e f_e * P_e.  probs (t, E) and
    ids (t, k); or, from the expert-parallel layer, (n, t, E) and (n, t,
    k), one slice per batch shard: the sum of the shards' losses over n,
    as the JAX package's ``_moe_layer_local`` returns it."""
    if probs.dim() == 3:
        n = probs.shape[0]
        return torch.stack([load_balance_loss(p, i, num_experts) / n
                            for p, i in zip(probs, ids)]).sum()
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=probs.device)
    flat = ids.reshape(-1).long()
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    frac_tokens = counts / max(ids.numel(), 1)
    return num_experts * torch.sum(frac_tokens * probs.mean(dim=0))


def _dispatch_slots(ids, num_experts: int, capacity: int):
    """The dispatch slot of every (token, choice) assignment, flattened to
    (t * k,): ``expert * capacity + rank within the expert``, or
    ``num_experts * capacity`` (the drop slot) past the capacity.  Ranks
    follow a stable sort by expert id, i.e. token order within an
    expert.  Returns (order, slot of the sorted assignments)."""
    flat_ids = ids.reshape(-1).long()
    order = torch.argsort(flat_ids, stable=True)     # group by expert
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(num_experts, device=ids.device), side="left")
    rank = torch.arange(flat_ids.shape[0], device=ids.device) \
        - seg_start[sorted_ids]
    drop = num_experts * capacity
    slot = torch.where(rank < capacity, sorted_ids * capacity + rank,
                       torch.full_like(rank, drop))
    return order, slot


def build_dispatch(ids, weights, num_experts: int, capacity: int):
    """Capacity-buffer dispatch tables from top-k assignments.

    ids/weights: (t, k).  Returns slot_token (E*C,) int32, the token
    feeding each expert slot (t = empty), and slot_weight (E*C,) f32, its
    combine weight.  Tokens over capacity are dropped."""
    return _build_dispatch(ids, weights, num_experts, capacity)[:2]


def _build_dispatch(ids, weights, num_experts: int, capacity: int):
    """:func:`build_dispatch`'s tables plus :func:`_dispatch_slots`'
    (order, slot), which the combine reads."""
    t, k = ids.shape
    order, slot = _dispatch_slots(ids, num_experts, capacity)
    n = num_experts * capacity
    token_of = torch.arange(t * k, device=ids.device) // k
    # one extra row catches the drop slot, as mode="drop" does in JAX
    slot_token = torch.full((n + 1,), t, dtype=torch.int32, device=ids.device)
    slot_token[slot] = token_of[order].to(torch.int32)
    slot_weight = torch.zeros((n + 1,), dtype=torch.float32,
                              device=ids.device)
    slot_weight[slot] = weights.reshape(-1)[order].float()
    return slot_token[:n], slot_weight[:n], order, slot


def expert_ffn(xd, p, cfg: ModelConfig):
    """Each expert's FFN on its dispatch buffer: K7's forward, and with
    grad on its backward too.

    xd: (E, C, d);  p["wi"]/p["wg"]: (E, d, ffe);  p["wo"]: (E, ffe, d)."""
    return moe_ffn(xd, p["wi"], p["wg"], p["wo"], activation=cfg.activation)


def _slots_of_tokens(slot, order, t: int, k: int):
    """(t, k): each token's dispatch slots in ascending order (a dropped
    choice: the drop slot, ``num_experts * capacity``)."""
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot                       # per (token, choice)
    return torch.sort(slot_of.view(t, k), dim=1).values


def _sum_slots(rows, per_token):
    """y[token] = sum of ``rows[slot]`` over the token's slots in
    ascending order, each add rounded to the working dtype, the drop slot
    reading a zero row appended to ``rows``."""
    rows = torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])
    y = rows[per_token[:, 0]]
    for j in range(1, per_token.shape[1]):
        y = y + rows[per_token[:, j]]
    return y


def _gather_slots(rows, slot_token):
    """(E*C, d): each slot's token row of ``rows`` (t, d), an empty slot
    (token t) a zero row."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])[
        slot_token.long()]


def _token_of_slots(per_token, n: int):
    """(n,) int64: each of the n dispatch slots' token, t where empty."""
    t, k = per_token.shape
    token = torch.full((n + 1,), t, dtype=torch.long,
                       device=per_token.device)
    # the drop slot n takes several tokens' writes; it is cut off
    token[per_token.reshape(-1)] = torch.arange(
        t, device=per_token.device).repeat_interleave(k)
    return token[:n]


class _DispatchGather(torch.autograd.Function):
    """:func:`_gather_slots` whose gradient is each token's own slots'
    rows summed (:func:`_sum_slots`), as the JAX package's scatter-add in
    slot order rounds them.  Autograd's backward of the index would
    scatter into the rows by sorting the slots' token ids instead, and
    every empty slot carries the id t: one run of thousands of rows
    (about 5,100 of phi-tiny-moe's 20,480 slots at 8,192 tokens) that a
    single warp of the card adds up one after another."""

    @staticmethod
    def forward(ctx, xt, slot_token, per_token):
        ctx.save_for_backward(per_token)
        return _gather_slots(xt, slot_token)

    @staticmethod
    def backward(ctx, dxd):
        per_token, = ctx.saved_tensors
        return _sum_slots(dxd, per_token), None, None


class _SumSlots(torch.autograd.Function):
    """:func:`_sum_slots` whose gradient is each slot's one token's row
    (:func:`_gather_slots`; an empty slot's zero), where autograd would
    scatter into the slots with every dropped choice on the drop row."""

    @staticmethod
    def forward(ctx, rows, per_token):
        ctx.save_for_backward(per_token)
        ctx.n = rows.shape[0]
        return _sum_slots(rows, per_token)

    @staticmethod
    def backward(ctx, dy):
        per_token, = ctx.saved_tensors
        return _gather_slots(dy, _token_of_slots(per_token, ctx.n)), None


def _combine(out, slot_weight, slot, order, t: int, k: int):
    """y[token] = sum over its slots of out[slot] * weight, in the working
    dtype.  The JAX code scatter-adds the (E*C, d) products into y in slot
    order, rounding after each add (XLA's CPU scatter applies updates in
    order); here each token sums its own k products in ascending slot
    order, which is the same sequence of roundings, in a fixed order on
    any device (``index_add_`` on CUDA adds with atomics in no fixed
    order).  A dropped choice adds an exact zero."""
    contrib = out * slot_weight[:, None].to(out.dtype)
    per_token = _slots_of_tokens(slot, order, t, k)
    if torch.is_grad_enabled() and contrib.requires_grad:
        return _SumSlots.apply(contrib, per_token)
    return _sum_slots(contrib, per_token)


def _route(xt, p, cfg: ModelConfig, capacity_factor: float):
    """Route the (t, d) rows ``xt`` with the router: (probs, ids, the
    capacity of each expert from the t rows, ``_build_dispatch``'s
    tables)."""
    mc = cfg.moe
    # a bf16 x against the f32 router promotes to f32, as jnp.einsum does
    logits = torch.einsum("td,de->te", xt.float(), p["router"].float())
    weights, ids, probs = router_topk(logits, mc.top_k)
    capacity = max(int(xt.shape[0] * mc.top_k / mc.num_experts
                       * capacity_factor), 4)
    return probs, ids, capacity, _build_dispatch(ids, weights,
                                                 mc.num_experts, capacity)


def expert_parallel(batch: int, cfg: ModelConfig, rules) -> bool:
    """The JAX package's condition for ``_moe_layer_local``: rules whose
    ``act_batch`` and ``experts`` axes are named, the first dividing the
    batch and the second the experts."""
    if rules is None:
        return False
    ax, eax = rules.axis("act_batch"), rules.axis("experts")
    return (ax is not None and eax is not None
            and batch % rules.axis_size(ax) == 0
            and cfg.moe.num_experts % rules.axis_size(eax) == 0)


def moe_layer(x, p, cfg: ModelConfig,
              capacity_factor: Optional[float] = None, rules=None,
              local_rows: bool = False, tp=None):
    """MoE FFN sublayer.  x: (b, s, d) -> (y, probs, ids): the output and
    the routing that :func:`load_balance_loss` reads.  The loss is left to
    the caller that wants it, so a decode step launches none of its work.

    The capacity comes from all b * s rows, so every row the caller
    passes (padding and idle batch rows included) takes its share of
    it, as in the JAX package.  Where :func:`expert_parallel` holds,
    :func:`_moe_layer_local` runs instead; ``local_rows`` (a training
    pass on a mesh: ``x`` holds this rank's rows, ``p`` its shard of the
    layer) runs :func:`_moe_layer_train`.  Both run each rank's rows
    through :func:`_expert_parallel`.  ``tp`` (a rank of tensor
    parallelism): the shared expert runs tensor-parallel
    (:func:`_plus_shared`), the router whole; the output comes back in
    the residual's layout."""
    mc = cfg.moe
    if capacity_factor is None:
        capacity_factor = mc.capacity_factor
    if local_rows:
        return _moe_layer_train(x, p, cfg, rules, capacity_factor, tp)
    if expert_parallel(x.shape[0], cfg, rules):
        return _moe_layer_local(x, p, cfg, rules, capacity_factor, tp)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)

    probs, ids, capacity, (slot_token, slot_weight, order, slot) = _route(
        xt, p, cfg, capacity_factor)

    # empty slots read row t, a zero row
    if torch.is_grad_enabled() and xt.requires_grad:
        xd = _DispatchGather.apply(
            xt, slot_token, _slots_of_tokens(slot, order, t, mc.top_k))
    else:
        xd = _gather_slots(xt, slot_token)
    xd = xd.view(mc.num_experts, capacity, d)
    out = expert_ffn(xd, p, cfg).view(mc.num_experts * capacity, d)
    y = _combine(out, slot_weight, slot, order, t, mc.top_k).view(b, s, d)
    if tp is not None:
        y = tp.out(y, "whole")
    return _plus_shared(y, x, p, cfg, tp), probs, ids


def _shared_ff(cfg: ModelConfig) -> int:
    return cfg.moe.d_ff_shared * cfg.moe.num_shared_experts


def _plus_shared(y, x, p, cfg: ModelConfig, tp):
    """``y`` plus the shared expert's output on ``x`` (tensor-parallel
    with ``tp``), where the layer has one."""
    if not cfg.moe.num_shared_experts:
        return y
    return y + mlp(x, p["shared"], cfg, tp, _shared_ff(cfg))


def _expert_parallel(xt, p, cfg: ModelConfig, rules,
                     capacity_factor: float, partial: bool = False):
    """The core of the JAX package's ``_moe_layer_local`` on one (data i,
    model j) rank, for decode and training alike: route the rank's own
    (t, d) rows ``xt`` with the (replicated) router, the capacity from
    those rows; keep the dispatch slots of the ``E / |experts|`` experts
    the rank holds (``p``'s ``wi``, ``wg``, ``wo``: this rank's experts
    alone, whole along d), run their FFN (K7), combine each row's own
    slots in ascending order and sum over the experts' ranks (in f32,
    rounded once: XLA's bf16 add).  Differentiable: the dispatch gather
    and the combine are each other's gradient (:class:`_DispatchGather`,
    :class:`_SumSlots`), the sum's gradient passes back whole, and the
    rows and gate weights, which every rank of the group holds alike and
    spends on its own experts, get their gradients summed over the group;
    without grad each piece is the plain gather, sum and all-reduce, bit
    for bit.  ``partial`` (a training pass under tensor parallelism over
    the experts' axis): the rank's experts' share of the output comes
    back unsummed, and the rows' and gate weights' gradients stay each
    rank's share (``sharding.TensorParallel``: the caller's collectives
    sum them).  Returns (y, probs, ids) of the rank's rows."""
    mc = cfg.moe
    t, d = xt.shape
    eax = rules.axis("experts")
    esize = rules.axis_size(eax)
    e_loc = mc.num_experts // esize
    if p["wi"].shape[0] != e_loc:
        raise ValueError(f"expert parallelism over {esize} ranks wants this "
                         f"rank's {e_loc} experts, got {p['wi'].shape[0]} "
                         f"(bridge.shard_decode, bridge.shard_train)")
    group = rules.mesh.group(eax)
    probs, ids, capacity, (slot_token, slot_weight, order, slot) = _route(
        xt, p, cfg, capacity_factor)
    n_loc = e_loc * capacity
    e0 = rules.mesh.axis_index(eax) * n_loc
    if not partial:
        # the gate weights' gradient reaches each slot from its one rank
        slot_weight = sum_grad_over(slot_weight, group)
        xt = sum_grad_over(xt, group)
    own_tok, own_w = slot_token[e0:e0 + n_loc], slot_weight[e0:e0 + n_loc]
    # each row's slots among this rank's, in ascending order; the others
    # (and a dropped choice) read the zero row n_loc
    per_token = _slots_of_tokens(slot, order, t, mc.top_k) - e0
    per_token = torch.where((per_token >= 0) & (per_token < n_loc),
                            per_token, torch.full_like(per_token, n_loc))
    xd = _DispatchGather.apply(xt, own_tok, per_token)
    out = expert_ffn(xd.view(e_loc, capacity, d), p, cfg).view(n_loc, d)
    y = _SumSlots.apply(out * own_w[:, None].to(out.dtype), per_token)
    return (y if partial else sum_over(y, group)), probs, ids


def _moe_layer_local(x, p, cfg: ModelConfig, rules, capacity_factor: float,
                     tp=None):
    """Expert parallelism in decode, as the JAX package's
    ``_moe_layer_local`` runs on each (data i, model j) device: the rank's
    own ``b / |act_batch|`` rows through :func:`_expert_parallel`, the
    rows gathered back over the batch's ranks; the shared expert then runs
    on every row, as there (tensor-parallel with ``tp``).  Returns (y,
    probs, ids), the routing of each batch shard stacked (n, t / n, ...)
    where the batch is split (n > 1)."""
    b, s, d = x.shape
    dax = rules.axis("act_batch")
    dsize = rules.axis_size(dax)
    b_loc = b // dsize
    i = rules.mesh.axis_index(dax)
    y, probs, ids = _expert_parallel(
        x[i * b_loc:(i + 1) * b_loc].reshape(b_loc * s, d), p, cfg, rules,
        capacity_factor)
    y = y.view(b_loc, s, d)
    if dsize > 1:
        dgroup, dorder = rules.mesh.group(dax), rules.mesh.group_order(dax)
        y = all_gather(y, dgroup, dorder)
        probs = all_gather(probs[None], dgroup, dorder)
        ids = all_gather(ids[None], dgroup, dorder)
    return _plus_shared(y, x, p, cfg, tp), probs, ids


def _moe_specs(cfg: ModelConfig, rules) -> dict:
    """One MoE layer's leaves' splits over a training rank's mesh."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else train_spec(rules, v.axes, v.shape)
                for k, v in node.items()}
    return walk(moe_schema(cfg))


def _moe_layer_train(x, p, cfg: ModelConfig, rules, capacity_factor: float,
                     tp=None):
    """The JAX package's ``_moe_layer_local`` in a training pass: ``x``
    holds this rank's own rows (the batch split over ``act_batch``, whose
    size n the rules give; None: every rank runs every row) and ``p`` its
    shard of the layer (``bridge.shard_train``: the ``E / |experts|``
    experts it holds, d_model split over ``data`` where it divides, the
    shared expert's hidden dim over ``model``).  The FSDP shards are
    gathered over ``data`` here (``gather_fsdp``; backward:
    reduce-scatter), then :func:`_expert_parallel` runs the rows (K7's
    ``MoeFFN``: training forward and backward).  With ``tp`` over the
    experts' axis the experts' partial sums and a split shared expert's
    go out in one collective (``tp.out``), in the residual's layout.
    Returns (y, probs, ids) of the rank's rows: the caller's loss over
    them is the shard's, which JAX divides by n (``aux[None] / dsize``)."""
    mc = cfg.moe
    p = gather_fsdp(p, _moe_specs(cfg, rules), rules)
    eax = rules.axis("experts")
    if eax is None or mc.num_experts % rules.axis_size(eax):
        # the experts stay whole on every rank: the global path, which
        # JAX takes too, over rows that must be all of the batch's
        if rules.axis_size(rules.axis("act_batch")) > 1:
            raise NotImplementedError(
                f"{mc.num_experts} experts over {rules.axis_size(eax)} "
                f"ranks with the batch split: the global dispatch over "
                f"every rank's rows is not ported")
        return moe_layer(x, p, cfg, capacity_factor, tp=tp)
    b, s, d = x.shape
    partial = tp is not None and eax == tp.axis
    y, probs, ids = _expert_parallel(x.reshape(b * s, d), p, cfg, rules,
                                     capacity_factor, partial)
    y = y.view(b, s, d)
    if tp is not None:
        y = tp.out(y, "partial" if partial else "whole")
    return _plus_shared(y, x, p, cfg, tp), probs, ids
