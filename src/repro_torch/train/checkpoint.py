"""Checkpointing: the flat-key npz of ``repro.train.checkpoint`` for the
parameters and the optimizer state.

The same keys (``params/<path>``, ``opt/mu/<path>``, ``opt/nu/<path>``,
``opt/step``, ``meta/step``) and the same bf16 encoding (``<key>@bfloat16``,
the uint16 bits), so a checkpoint written by either package restores in
the other.  No ``ml_dtypes``: bf16 moves through its bits.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.bridge import numpy_to_tensor, tensor_to_numpy
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
                    metadata: dict = None) -> None:
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


def restore_checkpoint(path, params_template, opt_template: AdamWState
                       ) -> Tuple[Any, AdamWState, int]:
    """Restore into the template's structure, dtypes and devices (shapes
    are checked)."""
    data = np.load(path)

    def rebuild(template, prefix):
        def leaf(path, t):
            key = prefix + "/".join(path)
            if key in data:
                arr = data[key]
                out = numpy_to_tensor(arr, arr.dtype.name, t.device)
            else:                                   # bf16 as uint16 bits
                arr = data[key + "@bfloat16"]
                out = numpy_to_tensor(arr, "bfloat16", t.device)
            if tuple(out.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(out.shape)} != "
                                 f"{tuple(t.shape)}")
            return out.to(t.dtype)

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                return leaf(path, node)
            return {k: walk(node[k], path + (k,)) for k in node}

        return walk(template, ())

    params = rebuild(params_template, "params/")
    step = torch.as_tensor(data["opt/step"], dtype=torch.int32,
                           device=opt_template.step.device)
    opt = AdamWState(step=step, mu=rebuild(opt_template.mu, "opt/mu/"),
                     nu=rebuild(opt_template.nu, "opt/nu/"))
    return params, opt, int(data["meta/step"])
