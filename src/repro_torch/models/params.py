"""Parameter schema of the decoder (dense, with serial or parallel blocks;
vlm, the dense stack with qkv bias; MoE with every layer an MoE layer;
MoE interleaved with dense layers, ``layer_period == 2``; the hybrid
family, Mamba2 layers and one shared attention block; and the ssm family,
xLSTM super-blocks of mLSTM blocks and one sLSTM block): one declaration
drives init and the bridge's shape checks.  Leaves are stacked over
layers (leading dims) exactly as in the JAX package, so the two parameter
trees line up key by key and shape by shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.xlstm import xlstm_dims

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | const:<v>
    dtype: str = "bfloat16"
    #: leading dims that stack weight matrices (layers, experts): init
    #: draws one matrix, ``shape[stacked:]``, at a time
    stacked: int = 0


def _stack(defs: dict, n: int, extra: int = 0) -> dict:
    """Prefix every ParamDef with the stacked layer dim(s): ``(n,)``, or
    ``(n, extra)`` for blocks stacked inside super-blocks."""
    lead = (n,) if not extra else (n, extra)
    return {k: _stack(v, n, extra) if isinstance(v, dict)
            else ParamDef(lead + v.shape, v.init, v.dtype,
                          v.stacked + len(lead))
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


def moe_schema(cfg: ModelConfig) -> dict:
    """Router (f32, as in the JAX package), the stacked expert FFNs and the
    optional shared expert (an MLP of the experts' summed width)."""
    mc = cfg.moe
    d, e, f = cfg.d_model, mc.num_experts, mc.d_ff_expert
    s = {
        "router": ParamDef((d, e), dtype="float32"),
        "wi": ParamDef((e, d, f), stacked=1),
        "wg": ParamDef((e, d, f), stacked=1),
        "wo": ParamDef((e, f, d), stacked=1),
    }
    if mc.num_shared_experts:
        s["shared"] = mlp_schema(cfg, mc.d_ff_shared * mc.num_shared_experts)
    return s


def mamba_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    sc = cfg.ssm
    d_inner, nh, conv_dim = ssm_dims(cfg)
    in_dim = d_inner + conv_dim + nh               # z, xBC, dt
    return {
        "in_proj": ParamDef((d, in_dim)),
        "conv_w": ParamDef((sc.conv_width, conv_dim)),
        "conv_b": ParamDef((conv_dim,), "zeros"),
        "dt_bias": ParamDef((nh,), "const:-2.0", "float32"),
        "A_log": ParamDef((nh,), "const:0.5", "float32"),
        "D": ParamDef((nh,), "ones", "float32"),
        "norm": ParamDef((d_inner,), "ones"),
        "out_proj": ParamDef((d_inner, d)),
    }


def mlstm_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, nh, hd = xlstm_dims(cfg)
    W = cfg.xlstm.conv_width
    return {
        "ln": ParamDef((d,), "ones"),
        "w_up": ParamDef((d, 2 * d_inner)),
        "conv_w": ParamDef((W, d_inner)),
        "conv_b": ParamDef((d_inner,), "zeros"),
        "wq": ParamDef((nh, hd, hd)),
        "wk": ParamDef((nh, hd, hd)),
        "wv": ParamDef((nh, hd, hd)),
        "w_gates": ParamDef((d_inner, 2 * nh)),
        "b_gates": ParamDef((2 * nh,), "const:3.0"),
        "out_norm": ParamDef((hd,), "ones"),
        "w_down": ParamDef((d_inner, d)),
    }


def slstm_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    f2 = int(d * cfg.xlstm.proj_factor_slstm)
    return {
        "ln": ParamDef((d,), "ones"),
        "w_in": ParamDef((d, nh, 4, hd)),
        "b_in": ParamDef((nh, 4, hd), "zeros"),
        "w_rec": ParamDef((nh, hd, 4, hd)),
        "gn": ParamDef((hd,), "ones"),
        "w_out": ParamDef((nh, hd, d)),
        "ln2": ParamDef((d,), "ones"),
        "mlp_wi": ParamDef((d, f2)),
        "mlp_wg": ParamDef((d, f2)),
        "mlp_wo": ParamDef((f2, d)),
    }


def is_moe(cfg: ModelConfig) -> bool:
    """Every layer is an MoE layer (``layer_period == 1``)."""
    return cfg.family == "moe" and cfg.moe.layer_period == 1


def is_interleaved(cfg: ModelConfig) -> bool:
    """Dense and MoE layers alternate, the MoE layer second of each pair
    (``layer_period == 2``, Llama-4)."""
    return cfg.family == "moe" and cfg.moe.layer_period == 2


def check_family(cfg: ModelConfig) -> None:
    """The families the port covers so far: dense, vlm (the dense stack
    with M-RoPE, qkv bias and prefix embeddings), MoE with every layer an
    MoE layer or every other one, hybrid (Mamba2 and a shared attention
    block) and ssm (xLSTM); not yet audio."""
    if not (cfg.family in ("dense", "vlm", "hybrid", "ssm") or is_moe(cfg)
            or is_interleaved(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense, vlm, hybrid and ssm "
            f"families and MoE with every layer or every other layer an "
            f"MoE layer so far (family {cfg.family!r})")
    if is_interleaved(cfg) and cfg.num_layers % 2:
        raise ValueError(f"{cfg.name}: interleaved dense/MoE pairs need an "
                         f"even layer count, got {cfg.num_layers}")
    if cfg.family == "ssm" and cfg.num_layers % cfg.xlstm.slstm_every:
        raise ValueError(f"{cfg.name}: xLSTM super-blocks of "
                         f"{cfg.xlstm.slstm_every} layers, got "
                         f"{cfg.num_layers}")


def _norms(cfg: ModelConfig, parallel: bool) -> dict:
    s = {"ln1": ParamDef((cfg.d_model,), "ones")}
    if not parallel:
        s["ln2"] = ParamDef((cfg.d_model,), "ones")
    return s


def build_schema(cfg: ModelConfig) -> dict:
    check_family(cfg)
    d = cfg.d_model
    schema: dict = {"embed": ParamDef((cfg.vocab_size, d))}
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamDef((d, cfg.vocab_size))
    schema["final_norm"] = ParamDef((d,), "ones")
    if is_interleaved(cfg):
        # the JAX package scans (dense, moe) pairs: layer 2i is
        # blocks["dense"][i], layer 2i + 1 blocks["moe"][i]
        dense = dict(_norms(cfg, False), attn=attention_schema(cfg),
                     mlp=mlp_schema(cfg))
        moe = dict(_norms(cfg, False), attn=attention_schema(cfg),
                   moe=moe_schema(cfg))
        schema["blocks"] = {"dense": _stack(dense, cfg.num_layers // 2),
                            "moe": _stack(moe, cfg.num_layers // 2)}
        return schema
    if cfg.family == "hybrid":
        schema["mamba_layers"] = _stack(
            {"ln1": ParamDef((d,), "ones"), "mamba": mamba_schema(cfg)},
            cfg.num_layers)
        # zamba2's signature: ONE shared attention + MLP block, reused
        # every ``attn_period`` layers
        schema["shared_attn"] = dict(_norms(cfg, False),
                                     attn=attention_schema(cfg),
                                     mlp=mlp_schema(cfg))
        return schema
    if cfg.family == "ssm":
        # xLSTM super-blocks of (slstm_every - 1) mLSTM blocks and 1 sLSTM
        per = cfg.xlstm.slstm_every
        n_super = cfg.num_layers // per
        schema["supers"] = {"mlstm": _stack(mlstm_schema(cfg), n_super,
                                            per - 1),
                            "slstm": _stack(slstm_schema(cfg), n_super)}
        return schema
    layer = dict(_norms(cfg, cfg.parallel_block))
    layer["attn"] = attention_schema(cfg)
    if is_moe(cfg):
        layer["moe"] = moe_schema(cfg)
    else:
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
    (which must live on that device).  A normal leaf is drawn in f32 one
    weight matrix at a time (the leaf past its stacked layer and expert
    dims, as one 2-D draw: an attention projection's heads merged into its
    columns), scaled in place and cast to its dtype, so a full-width model
    never stages more than one matrix in f32: 168 MB for one of
    Llama-4's experts, where a layer's 128 experts would be 21.5 GB.  The
    draws differ from ``jax.random``: tests carry JAX weights across with
    the bridge."""
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
        mat = pd.shape[pd.stacked:]
        draw = (mat[0], math.prod(mat[1:])) if len(mat) > 1 else mat
        for part in out.view((-1,) + mat):
            r = torch.randn(draw, generator=generator, device=dev)
            part.copy_(r.mul_(scale).view(mat))
        return out

    return _walk(build_schema(cfg), make)


def abstract_params(cfg: ModelConfig):
    """The parameter tree as tensors on the ``meta`` device, the schema's
    shapes and dtypes without storage: what a run will hold, reckoned
    before it allocates (the JAX package's ``ShapeDtypeStruct`` tree)."""
    return _walk(build_schema(cfg), lambda path, pd: torch.empty(
        pd.shape, dtype=TORCH_DTYPES[pd.dtype], device="meta"))


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(v) for v in params.values())
