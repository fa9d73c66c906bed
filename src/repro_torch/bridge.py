"""Parameters handed over as numpy arrays (e.g. from the JAX package),
and back.

bf16 leaves arrive with numpy's extension dtype ``bfloat16``; they move
bit-exactly as a uint16 view reinterpreted as ``torch.bfloat16``.  On the
way back (``params_to_numpy``) a bf16 leaf leaves as that uint16 view,
since numpy has no bf16 of its own: ``ml_dtypes``' ``bfloat16`` is
``.view(ml_dtypes.bfloat16)`` of it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import ParamDef, build_schema
from repro_torch.models.sharding import (Segments, kv_block_axes,
                                         shard_slices)


def _leaf(arr: np.ndarray, pd: ParamDef, path, dev) -> torch.Tensor:
    if tuple(arr.shape) != pd.shape:
        raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)} != "
                         f"schema {pd.shape}")
    bits = pd.dtype == "bfloat16" and arr.dtype == np.uint16
    if arr.dtype.name != pd.dtype and not bits:
        raise TypeError(f"{'/'.join(path)}: dtype {arr.dtype.name} != "
                        f"schema {pd.dtype}")
    return numpy_to_tensor(arr, pd.dtype, dev)


def numpy_to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A numpy array as a tensor of ``dtype`` (a schema dtype name) on
    ``device``; a bf16 one from ``ml_dtypes``' bfloat16 or from its uint16
    bits, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch tensors may not alias read-only
        arr = arr.copy()
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Nested dict of numpy arrays -> the port's parameter dict on
    ``device``, checked leaf by leaf against the schema of ``cfg`` (a bf16
    leaf as ``ml_dtypes``' bfloat16 or as its uint16 bits)."""
    dev = resolve_device(device)

    def walk(schema, node, path):
        if isinstance(schema, ParamDef):
            return _leaf(np.asarray(node), schema, path, dev)
        if set(node) != set(schema):
            raise KeyError(f"{'/'.join(path) or '<root>'}: keys "
                           f"{sorted(node)} != schema {sorted(schema)}")
        return {k: walk(schema[k], node[k], path + (k,)) for k in schema}

    return walk(build_schema(cfg), tree, ())


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host: bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def params_to_numpy(params):
    """The port's parameter dict -> the same nesting of numpy arrays, bf16
    leaves as uint16 views of their bits (the reverse of
    ``params_from_numpy``)."""
    if isinstance(params, torch.Tensor):
        return tensor_to_numpy(params)
    return {k: params_to_numpy(v) for k, v in params.items()}


def _expert_leaves(params):
    """The stacked MoE expert weight dicts of ``params`` (each holding
    ``wi``, ``wg``, ``wo`` of shape (layers, E, ...))."""
    if "blocks" in params:
        return [params["blocks"]["moe"]["moe"]]
    layers = params.get("layers", {})
    return [layers["moe"]] if "moe" in layers else []


def shard_decode(params, state, cfg: ModelConfig, rules):
    """This rank's shard of the full parameters and a full ``DecodeState``
    for ``serve_step(..., rules=rules)``: the experts it holds (E /
    |experts| of each MoE layer's ``wi``, ``wg``, ``wo``, where the batch
    takes the expert-parallel path) and its slots of the local and peer
    pools (the pools, ``slot_req`` and ``slot_base`` split over
    ``kv_blocks``: shard ``idx`` takes slots ``idx * n / shards`` on), and
    its block of every attention, MLP (the shared expert's too) and
    vocabulary weight that tensor parallelism splits over ``model``
    (``params.decode_specs``: q heads, kv heads where they divide, hidden
    columns, vocabulary rows, the recurrent layers' heads where they
    divide; the router and the norms stay whole).  Every other tensor is
    the same on every rank and is shared, not copied; the shards are
    copies, so the step's appends leave the full pools as they were.  The
    hybrid and ssm families' recurrent states keep the rank's rows where
    the batch divides over ``act_batch`` (``sharding.batch_rows``) and
    its heads where the layers split them (``model.state_specs``), as
    ``serve_step(rules)`` runs them.  The experts' weights over ``data``
    (FSDP) stay whole: GSPMD's gathers of them are not ported."""
    from repro_torch.models.model import shard_states
    from repro_torch.models.moe import expert_parallel

    if cfg.moe is not None and expert_parallel(state.tokens.shape[0], cfg,
                                               rules):
        eax = rules.axis("experts")
        e_loc = cfg.moe.num_experts // rules.axis_size(eax)
        e0 = rules.mesh.axis_index(eax) * e_loc

        experts = {id(d) for d in _expert_leaves(params)}

        def cut(node):
            if id(node) in experts:
                return {k: (v[:, e0:e0 + e_loc].clone()
                            if k in ("wi", "wg", "wo") else v)
                        for k, v in node.items()}
            if isinstance(node, dict):
                return {k: cut(v) for k, v in node.items()}
            return node

        params = cut(params)
    axes = kv_block_axes(rules)
    shards, idx = rules.axis_size(axes), rules.mesh.axis_index(axes)

    def pools(kv):
        if kv is None:
            return None
        n = kv.slot_req.shape[0]
        if n % shards:
            raise ValueError(f"{n} slots over {shards} shards")
        lo, hi = idx * n // shards, (idx + 1) * n // shards
        return kv._replace(pool_k=kv.pool_k[:, lo:hi].clone(),
                           pool_v=kv.pool_v[:, lo:hi].clone(),
                           slot_req=kv.slot_req[lo:hi].clone(),
                           slot_base=kv.slot_base[lo:hi].clone())

    from repro_torch.models.params import decode_specs
    params = _map_with_specs(
        lambda t, spec: t if not any(spec) else
        t[shard_slices(rules, spec, t.shape)].clone(), params,
        decode_specs(cfg, rules))
    states = state.states
    if states is not None:
        states = shard_states(cfg, states, rules)
    return params, state._replace(kv=pools(state.kv), peer=pools(state.peer),
                                  states=states)


def _map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a parameter-shaped tree and its
    ``param_specs``, nested as ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return {k: _map_with_specs(fn, v, specs[k]) for k, v in tree.items()}


def shard_train(params, opt, cfg: ModelConfig, rules):
    """This rank's shard, for ``train_step(..., rules=rules)``, of full
    parameters and of their AdamW state ``opt`` (or None): each leaf's
    block as ``param_specs`` splits it (``embed_fsdp`` over ``data``;
    ``experts``, ``heads``, ``kv_heads``, ``ff``, ``vocab`` and the
    recurrent layers' heads over ``model``), copied; a leaf left whole is
    shared.  Returns (params, opt)."""
    from repro_torch.models.params import param_specs

    specs = param_specs(cfg, rules)

    def cut(tree):
        return _map_with_specs(
            lambda t, spec: t if not any(spec) else
            t[shard_slices(rules, spec, t.shape)].clone(), tree, specs)

    if opt is None:
        return cut(params), None
    return cut(params), opt._replace(step=opt.step.clone(), mu=cut(opt.mu),
                                     nu=cut(opt.nu))


#: the most bytes of a rank's shard that :func:`gather_train` gathers in one
#: piece (the gathered piece is as many times larger as ranks split it)
GATHER_PIECE_BYTES = 64 * 2 ** 20


@torch.no_grad()
def gather_train(params, opt, cfg: ModelConfig, rules, dst=0):
    """The full parameters and AdamW state (or None) from every rank's
    shard (:func:`shard_train`'s inverse), on the host: each split leaf
    gathered over the ranks along each split dim, one leaf at a time and,
    where no axis splits its first dim, in pieces along that dim of at
    most ``GATHER_PIECE_BYTES`` of the shard (one layer of a stack, at
    least), each piece copied to the host and freed before the next, so a
    rank's device holds no more than its shard and one gathered piece.
    Collective: every rank calls it.  Rank ``dst`` gets the full trees
    (CPU tensors, copies) and every other rank (None, None), keeping
    nothing; ``dst`` None: every rank gets them."""
    from repro_torch.core.collectives import all_gather
    from repro_torch.models.params import param_specs

    specs = param_specs(cfg, rules)
    mesh = rules.mesh
    keep = dst is None or torch.distributed.get_rank() == dst

    def gathered(t, spec):
        for d, ax in enumerate(spec):
            if ax is not None:
                got = all_gather(t.movedim(d, 0), mesh.group(ax),
                                 mesh.group_order(ax)).movedim(0, d)
                t = ax.join(got.chunk(rules.axis_size(ax), d), d) \
                    if isinstance(ax, Segments) else got
        return t

    def whole(t, spec):
        if not any(spec):
            return t.to("cpu", copy=True) if keep else None
        if spec[0] is not None:
            part = gathered(t, spec)            # collective on every rank
            return part.to("cpu", copy=True) if keep else None
        row = t[0].numel() * t.element_size()
        step = max(GATHER_PIECE_BYTES // max(row, 1), 1)
        out = None
        for i in range(0, t.shape[0], step):
            part = gathered(t[i:i + step], spec)
            if keep:
                if out is None:
                    out = torch.empty((t.shape[0],) + part.shape[1:],
                                      dtype=t.dtype, device="cpu")
                out[i:i + step].copy_(part)
            del part
        return out

    def full(tree):
        return _map_with_specs(whole, tree, specs)

    p = full(params)
    o = None if opt is None else opt._replace(
        step=opt.step.to("cpu", copy=True), mu=full(opt.mu), nu=full(opt.nu))
    return (p, o) if keep else (None, None)
