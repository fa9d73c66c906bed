"""Parameter schema of the dense decoder: one declaration drives init and
the bridge's shape checks.  Leaves are stacked over layers (leading dim)
exactly as in the JAX package, so the two parameter trees line up key by
key and shape by shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | const:<v>
    dtype: str = "bfloat16"


def _stack(defs: dict, n: int) -> dict:
    """Prefix every ParamDef with the stacked layer dim."""
    return {k: _stack(v, n) if isinstance(v, dict)
            else ParamDef((n,) + v.shape, v.init, v.dtype)
            for k, v in defs.items()}


def attention_schema(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = {
        "wq": ParamDef((d, nq, hd)),
        "wk": ParamDef((d, nkv, hd)),
        "wv": ParamDef((d, nkv, hd)),
        "wo": ParamDef((nq, hd, d)),
    }
    if cfg.attn_bias:
        s["bq"] = ParamDef((nq, hd), "zeros")
        s["bk"] = ParamDef((nkv, hd), "zeros")
        s["bv"] = ParamDef((nkv, hd), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamDef((hd,), "ones")
        s["k_norm"] = ParamDef((hd,), "ones")
    return s


def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    s = {"wi": ParamDef((d, f)), "wo": ParamDef((f, d))}
    if cfg.gated_mlp:
        s["wg"] = ParamDef((d, f))
    return s


def _norms(cfg: ModelConfig, parallel: bool) -> dict:
    s = {"ln1": ParamDef((cfg.d_model,), "ones")}
    if not parallel:
        s["ln2"] = ParamDef((cfg.d_model,), "ones")
    return s


def build_schema(cfg: ModelConfig) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port covers the dense family so far, not {cfg.family!r}")
    d = cfg.d_model
    schema: dict = {"embed": ParamDef((cfg.vocab_size, d))}
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamDef((d, cfg.vocab_size))
    schema["final_norm"] = ParamDef((d,), "ones")
    layer = dict(_norms(cfg, cfg.parallel_block))
    layer["attn"] = attention_schema(cfg)
    layer["mlp"] = mlp_schema(cfg)
    schema["layers"] = _stack(layer, cfg.num_layers)
    return schema


def _walk(schema, fn, path=()):
    if isinstance(schema, ParamDef):
        return fn(path, schema)
    return {k: _walk(v, fn, path + (k,)) for k, v in schema.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """Materialise parameters directly on ``device`` from ``generator``
    (which must live on that device).  Normal leaves are drawn in f32 one
    leading-dim slice at a time and cast to their dtype, so a full-width
    model never stages a whole f32 stack.  The draws differ from
    ``jax.random``: tests carry JAX weights across with the bridge."""
    dev = resolve_device(device)

    def make(path, pd: ParamDef):
        dtype = TORCH_DTYPES[pd.dtype]
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        if pd.init.startswith("const:"):
            return torch.full(pd.shape, float(pd.init.split(":")[1]),
                              dtype=dtype, device=dev)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        scale = min(0.02, 1.0 / math.sqrt(max(fan_in, 1)))
        out = torch.empty(pd.shape, dtype=dtype, device=dev)
        for part in (out if out.dim() >= 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev) * scale)
        return out

    return _walk(build_schema(cfg), make)


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(v) for v in params.values())
