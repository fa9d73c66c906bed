"""Logical-axis sharding rules (MaxText-style), over the port's mesh of ranks.

Model code names a tensor's dims by *logical* axes; a :class:`ShardingRules`
maps those to the axes of a :class:`repro_torch.launch.mesh.Mesh`.  With
``rules=None`` everything runs on one device, unchanged.

The JAX package hands the rules to GSPMD, which splits every annotated
tensor and inserts the collectives.  Eager PyTorch has no such compiler:
here the rules serve the explicit multi-rank paths alone (the decode step's
KV pool sharded over ``kv_blocks``, expert parallelism over ``act_batch``
and ``experts``, the recurrent states' rows over ``act_batch``; in
training and prefill also each rank's rows (:func:`batch_rows`) and each
parameter leaf and its AdamW moments split as :func:`train_spec` says),
which split their tensors and call the collectives themselves
(``repro_torch.core.collectives``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


# Default logical -> physical mapping for the (data, model) production mesh.
# "fsdp" style: weight embed dims shard over the data axis.
DEFAULT_RULES = {
    # activations
    "act_batch": "data",
    "act_seq": None,
    "act_embed": "model",   # residual-stream tensor sharding (remat residuals)
    "act_heads": "model",
    "act_ff": "model",
    # weights
    "embed_fsdp": "data",      # d_model dim of weight matrices
    "heads": "model",          # attention head output dims
    "kv_heads": "model",       # only used when num_kv_heads % axis_size == 0
    "ff": "model",             # dense FFN hidden dim
    "experts": "model",        # MoE expert dim
    "expert_capacity": "data",  # dispatch-buffer capacity dim (see moe.py)
    "expert_ff": None,
    "vocab": "model",
    # kv-cache / recurrent state
    "kv_blocks": ("data", "model"),   # paged KV pool block dim (flash-decode)
    "kv_seq": "model",                # prefill KV stack sequence dim
    "state_heads": "model",           # SSM / xLSTM recurrent state heads
    # layer-stacking dim is never sharded
    "layers": None,
}


@dataclass(frozen=True)
class ShardingRules:
    mesh: "object"      # repro_torch.launch.mesh.Mesh
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def axis(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, *logical_axes: Optional[str]) -> tuple:
        """The mesh axes of each logical axis (a PartitionSpec as a
        tuple).  Divisibility is the caller's job; this translates names."""
        return tuple(self.axis(a) for a in logical_axes)

    def axis_size(self, mesh_axis: Axis) -> int:
        return self.mesh.axis_size(mesh_axis)


def kv_block_axes(rules: ShardingRules) -> Axis:
    """The mesh axes the KV pools' slot dim is split over: ``kv_blocks``,
    or ``("data", "model")`` where the rules leave it out, as the JAX
    package's sharded decode reads them."""
    return rules.rules.get("kv_blocks", ("data", "model"))


def logical_to_spec(rules: Optional[ShardingRules], *logical_axes,
                    shape=None) -> tuple:
    """Translate logical axes to a PartitionSpec (as a tuple), dropping any
    mapping that does not divide the corresponding dimension of ``shape``
    evenly."""
    if rules is None:
        return ()
    axes = [rules.axis(a) for a in logical_axes]
    if shape is not None:
        for i, ax in enumerate(axes):
            if ax is None:
                continue
            if shape[i] % rules.axis_size(ax) != 0:
                axes[i] = None
    return tuple(axes)


def shard(x, rules: Optional[ShardingRules], *logical_axes):
    """The identity: GSPMD's sharding constraints have no counterpart in
    eager PyTorch, so each rank holds whole what the explicit paths do not
    split."""
    return x


#: the logical axes whose splits a training rank holds: FSDP of weight
#: matrices' d_model dims and expert parallelism.  Tensor parallelism
#: (``heads``, ``ff``, ``vocab`` over ``model``) is GSPMD's choice of
#: layout in the JAX package, not other math: the port keeps those dims
#: whole, and the ``model`` ranks of one data index compute alike.
TRAIN_SPLITS = ("embed_fsdp", "experts")


def train_spec(rules: Optional[ShardingRules], axes, shape) -> tuple:
    """The mesh axes of each dim of a parameter leaf (logical ``axes``,
    () for none) in sharded training: ``logical_to_spec``'s, divisibility
    checked against ``shape``, of the dims named in ``TRAIN_SPLITS``;
    every other dim None.  Its AdamW moments split alike."""
    if rules is None:
        return ()
    axes = tuple(axes) or (None,) * len(shape)
    spec = logical_to_spec(rules, *axes, shape=shape)
    return tuple(ax if name in TRAIN_SPLITS else None
                 for ax, name in zip(spec, axes))


def batch_rows(rules: ShardingRules, b: int) -> Optional[slice]:
    """The rows of a global batch of ``b`` that this rank computes: its
    share along ``act_batch`` (the same on every rank of one data index),
    or None where the rows do not divide over that axis, as
    ``logical_to_spec`` drops an axis that does not divide: every rank
    then runs every row."""
    ax = rules.axis("act_batch")
    n = rules.axis_size(ax)
    if b % n:
        return None
    k = b // n
    i = rules.mesh.axis_index(ax)
    return slice(i * k, (i + 1) * k)


def strip_stacked(node, n: int):
    """A spec tree of stacked leaves with their ``n`` leading stack dims
    (never split) dropped: the split of one slice of the stack (one
    layer; one (super-block, block) of xLSTM's mLSTM stack)."""
    if isinstance(node, dict):
        return {k: strip_stacked(v, n) for k, v in node.items()}
    return node[n:]


def shard_slices(rules: ShardingRules, spec, shape) -> tuple:
    """This rank's block of a leaf of ``shape`` split as ``spec``: one
    slice per dim (chunk ``axis_index`` of ``axis_size`` along each split
    dim)."""
    out = []
    for n, ax in zip(shape, spec or (None,) * len(shape)):
        if ax is None:
            out.append(slice(None))
            continue
        k = n // rules.axis_size(ax)
        i = rules.mesh.axis_index(ax)
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def shard_shape(rules: ShardingRules, spec, shape) -> tuple:
    """The shape of this rank's block of a leaf of ``shape``."""
    return tuple(n if ax is None else n // rules.axis_size(ax)
                 for n, ax in zip(shape, spec or (None,) * len(shape)))


def gather_fsdp(tree, specs, rules: ShardingRules, skip=()):
    """``tree`` (a dict of parameter leaves, ``specs`` its
    ``param_specs``) with every leaf that is split over ``embed_fsdp``'s
    axis gathered whole along that dim, as the JAX package's FSDP gathers
    its weights: differentiable (``collectives.gather_over``; the backward
    reduce-scatters each gradient back to its shard), one collective per
    dtype.  Splits over other axes (the experts over ``model``) stay;
    the subtrees named in ``skip`` are returned as they are."""
    from repro_torch.core.collectives import gather_over

    axis = rules.axis("embed_fsdp")
    found = []
    _split_leaves(tree, specs, (), axis, skip, found)
    if not found:
        return tree
    whole = {}
    for dtype in dict.fromkeys(t.dtype for _, t, _ in found):
        part = [(p, t, d) for p, t, d in found if t.dtype == dtype]
        got = gather_over([t for _, t, _ in part], [d for _, _, d in part],
                          rules.mesh.group(axis))
        whole.update(zip((p for p, _, _ in part), got))
    return _replaced(tree, (), whole)


# module-level, not closures: a recursive closure is a reference cycle,
# which would keep the leaves it reaches (the gathered weights) alive
# until the cyclic collector runs


def _split_leaves(node, spec, path, axis, skip, found) -> None:
    """Append (path, leaf, dim) to ``found`` for each leaf of ``node``
    split over ``axis`` (the top-level keys in ``skip`` left out)."""
    if isinstance(node, dict):
        for k, v in node.items():
            if not (path == () and k in skip):
                _split_leaves(v, spec[k], path + (k,), axis, skip, found)
        return
    for d, ax in enumerate(spec or ()):
        if ax is not None and ax == axis:
            found.append((path, node, d))


def _replaced(node, path, whole):
    """``node`` with each leaf whose path is in ``whole`` replaced."""
    if not isinstance(node, dict):
        return whole.get(path, node)
    return {k: _replaced(v, path + (k,), whole) for k, v in node.items()}
