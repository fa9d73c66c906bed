"""Checkpointing: the flat-key npz of ``repro.train.checkpoint`` for the
parameters and the optimizer state.

The same keys (``params/<path>``, ``opt/mu/<path>``, ``opt/nu/<path>``,
``opt/step``, ``meta/step``) and the same bf16 encoding (``<key>@bfloat16``,
the uint16 bits), so a checkpoint written by either package restores in
the other.  No ``ml_dtypes``: bf16 moves through its bits.

On a mesh of ranks (``cfg`` and ``rules`` given, the trees a rank's
shards) a checkpoint is still the unsharded file: saving gathers the
shards (every rank calls it; rank 0 writes), restoring reads the whole
arrays and keeps each rank's block, so a checkpoint crosses between
meshes and between the packages alike.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import gather_train, numpy_to_tensor, tensor_to_numpy
from repro_torch.models.params import param_specs
from repro_torch.models.sharding import shard_slices
from repro_torch.train.optim import AdamWState, tree_paths


def _flatten(tree, prefix: str) -> dict:
    flat = {}
    for path, leaf in tree_paths(tree):
        key = prefix + "/".join(path)
        if leaf.dtype == torch.bfloat16:   # npz cannot round-trip bf16
            key += "@bfloat16"
        flat[key] = tensor_to_numpy(leaf)
    return flat


def save_checkpoint(path, params, opt_state: AdamWState, step: int,
                    metadata: dict = None, *, cfg=None, rules=None) -> None:
    """Write the npz (and ``metadata`` beside it as JSON).  With ``rules``
    the trees are a rank's shards of ``cfg``'s parameters: gathered whole
    first (collective), written by rank 0."""
    if rules is not None:
        params, opt_state = gather_train(params, opt_state, cfg, rules)
        if dist.get_rank() != 0:
            return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params, "params/")
    flat.update(_flatten(opt_state.mu, "opt/mu/"))
    flat.update(_flatten(opt_state.nu, "opt/nu/"))
    flat["opt/step"] = tensor_to_numpy(opt_state.step).astype(np.int32)
    flat["meta/step"] = np.asarray(step)
    np.savez(path, **flat)
    if metadata:
        Path(str(path) + ".json").write_text(json.dumps(metadata, indent=2))


def restore_checkpoint(path, params_template, opt_template: AdamWState,
                       *, cfg=None, rules=None
                       ) -> Tuple[Any, AdamWState, int]:
    """Restore into the template's structure, dtypes and devices (shapes
    are checked).  With ``rules`` the templates are a rank's shards of
    ``cfg``'s parameters: each whole array is cut to the rank's block."""
    data = np.load(path)
    specs = param_specs(cfg, rules) if rules is not None else None

    def rebuild(template, prefix):
        def leaf(path, t, spec):
            key = prefix + "/".join(path)
            if key in data:
                arr, dtype = data[key], data[key].dtype.name
            else:                                   # bf16 as uint16 bits
                arr, dtype = data[key + "@bfloat16"], "bfloat16"
            if spec and any(spec):
                arr = arr[shard_slices(rules, spec, arr.shape)]
            out = numpy_to_tensor(arr, dtype, t.device)
            if tuple(out.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(out.shape)} != "
                                 f"{tuple(t.shape)}")
            return out.to(t.dtype)

        def walk(node, path, spec):
            if isinstance(node, torch.Tensor):
                return leaf(path, node, spec)
            return {k: walk(node[k], path + (k,),
                            None if spec is None else spec[k]) for k in node}

        return walk(template, (), specs)

    params = rebuild(params_template, "params/")
    step = torch.as_tensor(data["opt/step"], dtype=torch.int32,
                           device=opt_template.step.device)
    opt = AdamWState(step=step, mu=rebuild(opt_template.mu, "opt/mu/"),
                     nu=rebuild(opt_template.nu, "opt/nu/"))
    return params, opt, int(data["meta/step"])
