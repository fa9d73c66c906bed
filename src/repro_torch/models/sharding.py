"""Logical-axis sharding rules (MaxText-style), over the port's mesh of ranks.

Model code names a tensor's dims by *logical* axes; a :class:`ShardingRules`
maps those to the axes of a :class:`repro_torch.launch.mesh.Mesh`.  With
``rules=None`` everything runs on one device, unchanged.

The JAX package hands the rules to GSPMD, which splits every annotated
tensor and inserts the collectives.  Eager PyTorch has no such compiler:
here the rules serve the explicit multi-rank paths alone (the decode step's
KV pool sharded over ``kv_blocks``, expert parallelism over ``act_batch``
and ``experts``), which split their tensors and call the collectives
themselves (``repro_torch.core.collectives``).
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
