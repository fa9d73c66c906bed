"""Logical-axis sharding rules (MaxText-style), over the port's mesh of ranks.

Model code names a tensor's dims by *logical* axes; a :class:`ShardingRules`
maps those to the axes of a :class:`repro_torch.launch.mesh.Mesh`.  With
``rules=None`` everything runs on one device, unchanged.

The JAX package hands the rules to GSPMD, which splits every annotated
tensor and inserts the collectives.  Eager PyTorch has no such compiler:
here the rules drive explicit multi-rank paths, which split their tensors
and call the collectives themselves (``repro_torch.core.collectives``):
the decode step's KV pool sharded over ``kv_blocks``, expert parallelism
over ``act_batch`` and ``experts``, the recurrent states' rows over
``act_batch``; in training and prefill each rank's rows
(:func:`batch_rows`) and each parameter leaf and its AdamW moments split
as :func:`train_spec` says; and tensor parallelism over ``model``
(:class:`TensorParallel`): attention's heads, the MLPs' ``ff``, the
vocabulary, the recurrent layers' heads (``state_heads``, with their
``ff`` channels) and, in training and prefill, the residual's d_model
(``act_embed``), as ``DEFAULT_RULES`` split them in the JAX package.
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
    eager PyTorch; the explicit paths split what they split themselves."""
    return x


#: the logical axes whose splits a training rank holds: FSDP of weight
#: matrices' d_model dims, expert parallelism, and tensor parallelism of
#: attention's q and kv heads, the MLPs' hidden dim and the vocabulary
#: (each where it divides; ``logical_to_spec`` drops the rest: yi-6b's 4
#: kv heads on a 16-way axis stay whole).  Each ``model`` rank computes
#: its own heads, ``ff`` columns and vocabulary rows
#: (:class:`TensorParallel`).
TRAIN_SPLITS = ("embed_fsdp", "experts", "heads", "kv_heads", "ff", "vocab")

#: the splits of the recurrent layers' own leaves (Mamba2's, mLSTM's and
#: sLSTM's): FSDP, and their ``ff`` channels and ``state_heads`` over
#: tensor parallelism's axis by heads, where the layer's heads divide it
#: (:func:`heads_axis`; a layer whose heads do not stays
#: whole and every ``model`` rank computes it alike).  A rank holds the
#: channels of its heads; a dim that mixes per-head channels with
#: channels every head reads (Mamba2's B and C) is laid out as
#: :class:`Segments` (``models.params.leaf_spec``)
RECURRENT_SPLITS = ("embed_fsdp", "ff", "state_heads")

#: the splits a decode rank holds (``bridge.shard_decode``): tensor
#: parallelism alone (the experts are cut where the batch takes the
#: expert-parallel path; d_model stays whole)
DECODE_SPLITS = ("heads", "kv_heads", "ff", "vocab")


def train_spec(rules: Optional[ShardingRules], axes, shape,
               splits=TRAIN_SPLITS) -> tuple:
    """The mesh axes of each dim of a parameter leaf (logical ``axes``,
    () for none) in sharded training: ``logical_to_spec``'s, divisibility
    checked against ``shape``, of the dims named in ``splits``
    (``TRAIN_SPLITS``; ``RECURRENT_SPLITS`` for a recurrent layer's
    leaf); every other dim None.  Its AdamW moments split alike."""
    if rules is None:
        return ()
    axes = tuple(axes) or (None,) * len(shape)
    spec = logical_to_spec(rules, *axes, shape=shape)
    return tuple(ax if name in splits else None
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


class Segments(str):
    """A spec entry for a dim laid out as consecutive segments (``parts``:
    (length, split) each) over the mesh axis it names (it compares, and
    looks groups up, as that name): a rank holds, in order, its block of
    each split segment (block ``axis_index`` of ``axis_size``) and the
    whole of each other.  Mamba2's ``in_proj`` columns (z | x | B C | dt):
    the z and x channels and dt entries of the rank's heads, B and C
    alike on every rank.  The positions held alike have a gradient that
    is a share of the whole one (``train.optim._sync_grads`` sums them
    over the axis)."""

    def __new__(cls, axis: str, parts):
        self = super().__new__(cls, axis)
        self.parts = tuple((int(n), bool(split)) for n, split in parts)
        return self

    def __getnewargs__(self):
        return str(self), self.parts

    def __repr__(self) -> str:
        return f"Segments({str(self)!r}, {self.parts})"

    def _runs(self, size: int):
        """(first local position, first global position, length, split)
        of each segment on a rank, block 0 of the split ones."""
        local = glob = 0
        for n, split in self.parts:
            k = n // size if split else n
            yield local, glob, k, split
            local, glob = local + k, glob + n

    def index(self, size: int, i: int) -> list:
        """The global positions rank ``i`` of ``size`` holds, in order."""
        return [g + (i * k if split else 0) + j
                for _, g, k, split in self._runs(size) for j in range(k)]

    def length(self, size: int) -> int:
        return sum(k for _, _, k, _ in self._runs(size))

    def shared(self, size: int) -> list:
        """The local positions every rank holds alike."""
        return [at + j for at, _, k, split in self._runs(size)
                if not split for j in range(k)]

    def join(self, blocks, dim: int):
        """The whole dim from every rank's block (``blocks``, in rank
        order): each split segment's blocks laid end to end, each other
        segment from the first rank."""
        import torch
        parts = []
        for at, _, k, split in self._runs(len(blocks)):
            parts.extend(b.narrow(dim, at, k)
                         for b in (blocks if split else blocks[:1]))
        return torch.cat(parts, dim)


def shard_slices(rules: ShardingRules, spec, shape) -> tuple:
    """This rank's block of a leaf of ``shape`` split as ``spec``: one
    index per dim (chunk ``axis_index`` of ``axis_size`` along each split
    dim; along a :class:`Segments` dim, the list of its positions)."""
    out = []
    for n, ax in zip(shape, spec or (None,) * len(shape)):
        if ax is None:
            out.append(slice(None))
            continue
        i, size = rules.mesh.axis_index(ax), rules.axis_size(ax)
        if isinstance(ax, Segments):
            if n != sum(k for k, _ in ax.parts):
                raise ValueError(f"{ax!r} over a dim of {n}")
            out.append(ax.index(size, i))
            continue
        k = n // size
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def shard_shape(rules: ShardingRules, spec, shape) -> tuple:
    """The shape of this rank's block of a leaf of ``shape``."""
    return tuple(n if ax is None else
                 ax.length(rules.axis_size(ax)) if isinstance(ax, Segments)
                 else n // rules.axis_size(ax)
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


# ---------------------------------------------------------------------------
# Tensor parallelism over ``model``
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorParallel:
    """A rank's place in tensor parallelism: the mesh axis that the rules
    map ``heads`` to (``model``), split ``size`` ways, this rank
    ``index``-th.  A leaf dim named ``heads``, ``kv_heads``, ``ff`` or
    ``vocab`` that divides (:meth:`splits`) holds the rank's block: q
    heads, kv heads, hidden columns, vocabulary rows; a recurrent layer
    whose heads divide (:func:`heads_axis`) holds its heads; the layers
    compute their block and hand the rest to the collectives below.

    ``split_residual`` (training and prefill): the residual stream holds
    the rank's block of d_model (``act_embed``), as the JAX package keeps
    its checkpointed block inputs.  :meth:`whole` gathers it before each
    norm, and a sublayer's output comes back in that layout
    (:meth:`out`): a row-parallel product's partial sums reduce-scattered,
    a whole output cut to the rank's block.  Every tensor that every rank
    holds alike (the gathered stream, the normed input) then carries, on
    each rank, the share of its gradient that the rank's own work gives:
    the gather's backward sums them, and a leaf that ``model`` does not
    split has its gradient summed over ``model`` by the step
    (``train.optim._sync_grads``).  Without it (decode) the stream is
    whole on every rank and a partial sum is all-reduced."""
    rules: ShardingRules
    axis: str
    size: int
    index: int
    split_residual: bool = False

    @property
    def group(self):
        return self.rules.mesh.group(self.axis)

    def splits(self, logical: str, n: int) -> bool:
        """A dim of ``n`` named ``logical`` is split over this axis."""
        return self.rules.axis(logical) == self.axis and n % self.size == 0

    def block(self, n: int) -> slice:
        """This rank's block of a split dim of ``n``."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def whole(self, x):
        """The residual stream ``x`` whole along d_model (gathered where
        it is split; differentiable)."""
        if not self.split_residual:
            return x
        from repro_torch.core.collectives import (TENSOR_PARALLEL,
                                                  gather_over, tagged)
        with tagged(TENSOR_PARALLEL):
            return gather_over([x], [x.dim() - 1], self.group)[0]

    def shard(self, x):
        """A tensor every rank holds whole and alike, in the residual's
        layout: the rank's block of d_model where it is split."""
        if not self.split_residual:
            return x
        return x[..., self.block(x.shape[-1])]

    def out(self, y, kind: str, bias=None, dtype=None):
        """A sublayer's output in the residual's layout.  ``kind``:
        "partial" (each rank's share of a row-parallel product, f32 where
        ``row_parallel`` made it: summed over the axis in f32 and rounded
        once to ``dtype``, reduce-scattered where the stream is split),
        "rows" (the rank's block of the sequence, dim 1: gathered) or
        "whole" (alike on every rank).  ``bias`` (whole) is added once,
        after the sum."""
        from repro_torch.core.collectives import (TENSOR_PARALLEL,
                                                  gather_over, reduce_scatter,
                                                  sum_over, tagged)
        with tagged(TENSOR_PARALLEL):
            if kind == "rows":
                y = gather_over([y], [1], self.group)[0]
            if kind == "partial" and self.split_residual:
                y = reduce_scatter([y], [y.dim() - 1], self.group)[0]
                bias = None if bias is None else self.shard(bias)
            elif kind == "partial":
                y = sum_over(y, self.group)
        if kind == "partial":
            y = y if dtype is None else y.to(dtype)
            return y if bias is None else y + bias
        y = y if bias is None else y + bias
        return self.shard(y)


def heads_axis(rules: Optional[ShardingRules], *counts: int
               ) -> Optional[str]:
    """The mesh axis a recurrent layer's heads split over, or None:
    tensor parallelism's (the axis of ``heads``, more than one rank),
    where ``state_heads`` and ``ff`` map to it too and each of ``counts``
    (the layer's heads; for sLSTM's MLP, its heads and hidden width)
    divides it."""
    if rules is None:
        return None
    axis = rules.axis("heads")
    if not isinstance(axis, str) or rules.axis_size(axis) == 1 \
            or rules.axis("state_heads") != axis or rules.axis("ff") != axis:
        return None
    size = rules.axis_size(axis)
    return axis if all(n % size == 0 for n in counts) else None


def tensor_parallel(rules: Optional[ShardingRules],
                    d_model: Optional[int] = None
                    ) -> Optional[TensorParallel]:
    """The rank's :class:`TensorParallel`, or None where the rules split
    nothing over the axis of ``heads`` (no rules, no such axis, one rank
    along it).  ``d_model`` (training and prefill): the residual splits
    over that axis too (``act_embed``, which must name it and divide
    d_model)."""
    if rules is None:
        return None
    axis = rules.axis("heads")
    if axis is None or rules.axis_size(axis) == 1:
        return None
    if not isinstance(axis, str):
        raise NotImplementedError(f"tensor parallelism over one mesh axis, "
                                  f"not {axis}")
    size = rules.axis_size(axis)
    if d_model is not None and (rules.axis("act_embed") != axis
                                or d_model % size):
        raise NotImplementedError(
            f"training and prefill split the residual's d_model "
            f"({d_model}) over {axis!r} ({size}) with the heads: "
            f"act_embed must name it and divide d_model")
    return TensorParallel(rules, axis, size, rules.mesh.axis_index(axis),
                          split_residual=d_model is not None)
