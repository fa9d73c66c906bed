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
