"""Parameters handed over as numpy arrays (e.g. from the JAX package).

bf16 leaves arrive with numpy's extension dtype ``bfloat16``; they move
bit-exactly as a uint16 view reinterpreted as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import ParamDef, build_schema


def _leaf(arr: np.ndarray, pd: ParamDef, path, dev) -> torch.Tensor:
    if tuple(arr.shape) != pd.shape:
        raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)} != "
                         f"schema {pd.shape}")
    if arr.dtype.name != pd.dtype:
        raise TypeError(f"{'/'.join(path)}: dtype {arr.dtype.name} != "
                        f"schema {pd.dtype}")
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch tensors may not alias read-only
        arr = arr.copy()
    if pd.dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dev)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Nested dict of numpy arrays -> the port's parameter dict on
    ``device``, checked leaf by leaf against the schema of ``cfg``."""
    dev = resolve_device(device)

    def walk(schema, node, path):
        if isinstance(schema, ParamDef):
            return _leaf(np.asarray(node), schema, path, dev)
        if set(node) != set(schema):
            raise KeyError(f"{'/'.join(path) or '<root>'}: keys "
                           f"{sorted(node)} != schema {sorted(schema)}")
        return {k: walk(schema[k], node[k], path + (k,)) for k in schema}

    return walk(build_schema(cfg), tree, ())
