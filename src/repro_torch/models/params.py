"""Parameter schema of the decoder (dense, with serial or parallel blocks;
vlm, the dense stack with qkv bias; MoE with every layer an MoE layer;
MoE interleaved with dense layers, ``layer_period == 2``; the hybrid
family, Mamba2 layers and one shared attention block; and the ssm family,
xLSTM super-blocks of mLSTM blocks and one sLSTM block; and the audio
family, MusicGen's dense stack of non-gated MLP blocks over codebooks,
each with its own embedding and head): one declaration
drives init and the bridge's shape checks.  Leaves are stacked over
layers (leading dims) exactly as in the JAX package, so the two parameter
trees line up key by key and shape by shape.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.sharding import (DECODE_SPLITS, RECURRENT_SPLITS,
                                         TRAIN_SPLITS, Segments, heads_axis,
                                         shard_shape, shard_slices,
                                         train_spec)
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.xlstm import slstm_dims, xlstm_dims

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | const:<v>
    dtype: str = "bfloat16"
    #: leading dims that stack weight matrices (layers, experts): init
    #: draws one matrix, ``shape[stacked:]``, at a time
    stacked: int = 0
    #: each dim's logical sharding axis (``repro.models.params``'s); ()
    #: for none on any dim; ``models.sharding.train_spec`` reads them
    axes: Tuple[Optional[str], ...] = ()
    #: a recurrent layer's leaf: the counts that must each divide tensor
    #: parallelism's axis for its ``ff`` / ``state_heads`` dim to split
    #: (the layer's heads; sLSTM's MLP: its heads and hidden width)
    units: Tuple[int, ...] = ()
    #: that dim's segments, (length, split by heads) each, where it is not
    #: one run of per-head channels (``sharding.Segments``)
    parts: Tuple[Tuple[int, bool], ...] = ()

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


def _stack(defs: dict, n: int, extra: int = 0) -> dict:
    """Prefix every ParamDef with the stacked layer dim(s): ``(n,)``, or
    ``(n, extra)`` for blocks stacked inside super-blocks."""
    lead = (n,) if not extra else (n, extra)
    return {k: _stack(v, n, extra) if isinstance(v, dict)
            else dataclasses.replace(v, shape=lead + v.shape,
                                     stacked=v.stacked + len(lead),
                                     axes=("layers",) * len(lead) + v.axes)
            for k, v in defs.items()}


def attention_schema(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = {
        "wq": ParamDef((d, nq, hd), axes=("embed_fsdp", "heads", None)),
        "wk": ParamDef((d, nkv, hd), axes=("embed_fsdp", "kv_heads", None)),
        "wv": ParamDef((d, nkv, hd), axes=("embed_fsdp", "kv_heads", None)),
        "wo": ParamDef((nq, hd, d), axes=("heads", None, "embed_fsdp")),
    }
    if cfg.attn_bias:
        s["bq"] = ParamDef((nq, hd), "zeros", axes=("heads", None))
        s["bk"] = ParamDef((nkv, hd), "zeros", axes=("kv_heads", None))
        s["bv"] = ParamDef((nkv, hd), "zeros", axes=("kv_heads", None))
    if cfg.qk_norm:
        s["q_norm"] = ParamDef((hd,), "ones")
        s["k_norm"] = ParamDef((hd,), "ones")
    return s


def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    s = {"wi": ParamDef((d, f), axes=("embed_fsdp", "ff")),
         "wo": ParamDef((f, d), axes=("ff", "embed_fsdp"))}
    if cfg.gated_mlp:
        s["wg"] = ParamDef((d, f), axes=("embed_fsdp", "ff"))
    return s


def moe_schema(cfg: ModelConfig) -> dict:
    """Router (f32, as in the JAX package), the stacked expert FFNs and the
    optional shared expert (an MLP of the experts' summed width)."""
    mc = cfg.moe
    d, e, f = cfg.d_model, mc.num_experts, mc.d_ff_expert
    s = {
        "router": ParamDef((d, e), dtype="float32",
                           axes=("embed_fsdp", None)),
        "wi": ParamDef((e, d, f), stacked=1,
                       axes=("experts", "embed_fsdp", None)),
        "wg": ParamDef((e, d, f), stacked=1,
                       axes=("experts", "embed_fsdp", None)),
        "wo": ParamDef((e, f, d), stacked=1,
                       axes=("experts", None, "embed_fsdp")),
    }
    if mc.num_shared_experts:
        s["shared"] = mlp_schema(cfg, mc.d_ff_shared * mc.num_shared_experts)
    return s


def mamba_schema(cfg: ModelConfig) -> dict:
    """Mamba2's leaves.  Split by heads, a rank holds the z and x channels
    and dt entries of its heads and every B and C channel (``in_proj``'s
    columns z | x | B C | dt, the conv's x | B C); ``dt_bias``, ``A_log``
    and ``D`` whole, of which it reads its heads'."""
    d = cfg.d_model
    sc = cfg.ssm
    d_inner, nh, conv_dim = ssm_dims(cfg)
    in_dim = d_inner + conv_dim + nh               # z, xBC, dt
    bc = (2 * sc.state_dim, False)
    heads = dict(units=(nh,))
    return {
        "in_proj": ParamDef((d, in_dim), axes=("embed_fsdp", "ff"),
                            parts=((d_inner, True), (d_inner, True), bc,
                                   (nh, True)), **heads),
        "conv_w": ParamDef((sc.conv_width, conv_dim), axes=(None, "ff"),
                           parts=((d_inner, True), bc), **heads),
        "conv_b": ParamDef((conv_dim,), "zeros", axes=("ff",),
                           parts=((d_inner, True), bc), **heads),
        "dt_bias": ParamDef((nh,), "const:-2.0", "float32"),
        "A_log": ParamDef((nh,), "const:0.5", "float32"),
        "D": ParamDef((nh,), "ones", "float32"),
        "norm": ParamDef((d_inner,), "ones", axes=("ff",), **heads),
        "out_proj": ParamDef((d_inner, d), axes=("ff", "embed_fsdp"),
                             **heads),
    }


def mlstm_schema(cfg: ModelConfig) -> dict:
    """An mLSTM block's leaves.  Split by heads, a rank holds the xm and z
    columns of its heads (``w_up``'s xm | z), their conv channels, q, k
    and v projections and rows of ``w_gates`` and ``w_down``;
    ``b_gates`` (the heads' (i, f) pairs) whole."""
    d = cfg.d_model
    d_inner, nh, hd = xlstm_dims(cfg)
    W = cfg.xlstm.conv_width
    heads = dict(units=(nh,))
    return {
        "ln": ParamDef((d,), "ones"),
        "w_up": ParamDef((d, 2 * d_inner), axes=("embed_fsdp", "ff"),
                         parts=((d_inner, True), (d_inner, True)), **heads),
        "conv_w": ParamDef((W, d_inner), axes=(None, "ff"), **heads),
        "conv_b": ParamDef((d_inner,), "zeros", axes=("ff",), **heads),
        "wq": ParamDef((nh, hd, hd), axes=("state_heads", None, None),
                       **heads),
        "wk": ParamDef((nh, hd, hd), axes=("state_heads", None, None),
                       **heads),
        "wv": ParamDef((nh, hd, hd), axes=("state_heads", None, None),
                       **heads),
        "w_gates": ParamDef((d_inner, 2 * nh), axes=("ff", None), **heads),
        "b_gates": ParamDef((2 * nh,), "const:3.0"),
        "out_norm": ParamDef((hd,), "ones"),
        "w_down": ParamDef((d_inner, d), axes=("ff", "embed_fsdp"),
                           **heads),
    }


def slstm_schema(cfg: ModelConfig) -> dict:
    """An sLSTM block's leaves.  Split by heads, a rank holds its heads'
    input, recurrent and output weights, and, where the GEGLU MLP's
    hidden width divides too, its columns of ``mlp_wi`` and ``mlp_wg``
    and rows of ``mlp_wo``."""
    d = cfg.d_model
    nh, hd, f2 = slstm_dims(cfg)
    heads, mlp = dict(units=(nh,)), dict(units=(nh, f2))
    return {
        "ln": ParamDef((d,), "ones"),
        "w_in": ParamDef((d, nh, 4, hd),
                         axes=("embed_fsdp", "state_heads", None, None),
                         **heads),
        "b_in": ParamDef((nh, 4, hd), "zeros",
                         axes=("state_heads", None, None), **heads),
        "w_rec": ParamDef((nh, hd, 4, hd),
                          axes=("state_heads", None, None, None), **heads),
        "gn": ParamDef((hd,), "ones"),
        "w_out": ParamDef((nh, hd, d),
                          axes=("state_heads", None, "embed_fsdp"), **heads),
        "ln2": ParamDef((d,), "ones"),
        "mlp_wi": ParamDef((d, f2), axes=("embed_fsdp", "ff"), **mlp),
        "mlp_wg": ParamDef((d, f2), axes=("embed_fsdp", "ff"), **mlp),
        "mlp_wo": ParamDef((f2, d), axes=("ff", "embed_fsdp"), **mlp),
    }


def is_moe(cfg: ModelConfig) -> bool:
    """Every layer is an MoE layer (``layer_period == 1``)."""
    return cfg.family == "moe" and cfg.moe.layer_period == 1


def is_interleaved(cfg: ModelConfig) -> bool:
    """Dense and MoE layers alternate, the MoE layer second of each pair
    (``layer_period == 2``, Llama-4)."""
    return cfg.family == "moe" and cfg.moe.layer_period == 2


def num_codebooks(cfg: ModelConfig) -> int:
    """The audio family's parallel codebooks (MusicGen: 4), each with its
    own embedding table and head, or 0 for a model of one token stream."""
    if cfg.family == "audio" and cfg.modality.num_codebooks > 1:
        return cfg.modality.num_codebooks
    return 0


def check_family(cfg: ModelConfig) -> None:
    """The families the port covers: dense, vlm (the dense stack with
    M-RoPE, qkv bias and prefix embeddings), audio (the dense stack over
    parallel codebooks, sinusoidal positions, prefix embeddings), MoE with
    every layer an MoE layer or every other one, hybrid (Mamba2 and a
    shared attention block) and ssm (xLSTM)."""
    if not (cfg.family in ("dense", "vlm", "audio", "hybrid", "ssm")
            or is_moe(cfg) or is_interleaved(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense, vlm, audio, hybrid and "
            f"ssm families and MoE with every layer or every other layer an "
            f"MoE layer (family {cfg.family!r})")
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
    ncb = num_codebooks(cfg)
    if ncb:
        # one embedding table and one head per codebook
        schema: dict = {
            "embed": ParamDef((ncb, cfg.vocab_size, d), stacked=1,
                              axes=(None, "vocab", "embed_fsdp")),
            "lm_head": ParamDef((ncb, d, cfg.vocab_size), stacked=1,
                                axes=(None, "embed_fsdp", "vocab"))}
    else:
        schema = {"embed": ParamDef((cfg.vocab_size, d),
                                    axes=("vocab", "embed_fsdp"))}
        if not cfg.tie_embeddings:
            schema["lm_head"] = ParamDef((d, cfg.vocab_size),
                                         axes=("embed_fsdp", "vocab"))
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


def _recurrent(path) -> bool:
    """The leaf at ``path`` is a recurrent layer's own (Mamba2's, an mLSTM
    or sLSTM block's)."""
    return path[:1] == ("supers",) or path[:2] == ("mamba_layers", "mamba")


def leaf_spec(rules, path, pd: ParamDef) -> tuple:
    """The split of the leaf at ``path`` over a training rank's mesh:
    ``train_spec`` with ``TRAIN_SPLITS``; a recurrent layer's leaf with
    ``RECURRENT_SPLITS``: ``embed_fsdp`` where it divides, and its ``ff``
    or ``state_heads`` dim over tensor parallelism's axis by heads where
    the layer's counts divide it (``pd.units``,
    ``sharding.heads_axis``), as :class:`~repro_torch.models.
    sharding.Segments` where the dim holds segments every rank holds
    alike (``pd.parts``; ``shard_slices`` gives the positions)."""
    if not _recurrent(path):
        return train_spec(rules, pd.axes, pd.shape, TRAIN_SPLITS)
    spec = train_spec(rules, pd.axes, pd.shape, ("embed_fsdp",))
    axis = heads_axis(rules, *pd.units) if pd.units else None
    if axis is None:
        return spec
    head_dims = set(RECURRENT_SPLITS) - {"embed_fsdp"}
    return tuple((Segments(axis, pd.parts) if pd.parts else axis)
                 if name in head_dims else ax
                 for ax, name in zip(spec, pd.axes))


def _walk(schema, fn, path=()):
    if isinstance(schema, ParamDef):
        return fn(path, schema)
    return {k: _walk(v, fn, path + (k,)) for k, v in schema.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", rules=None):
    """Materialise parameters directly on ``device`` from ``generator``
    (which must live on that device).  A normal leaf is drawn in f32 one
    weight matrix at a time (the leaf past its stacked layer and expert
    dims, as one 2-D draw: an attention projection's heads merged into its
    columns), scaled in place and cast to its dtype, so a full-width model
    never stages more than one matrix in f32: 168 MB for one of
    Llama-4's experts, where a layer's 128 experts would be 21.5 GB.  The
    draws differ from ``jax.random``: tests carry JAX weights across with
    the bridge.

    ``rules`` (a training rank's mesh): every rank draws the same full
    matrices in the same order and keeps only its block of each leaf
    (:func:`param_specs`), so the ranks' blocks together are the
    unsharded draw, and a rank holds no more than its shard and one
    matrix."""
    dev = resolve_device(device)

    def make(path, pd: ParamDef):
        dtype = TORCH_DTYPES[pd.dtype]
        spec = leaf_spec(rules, path, pd)
        shape = shard_shape(rules, spec, pd.shape) if rules else pd.shape
        if pd.init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if pd.init.startswith("const:"):
            return torch.full(shape, float(pd.init.split(":")[1]),
                              dtype=dtype, device=dev)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        scale = min(0.02, 1.0 / math.sqrt(max(fan_in, 1)))
        out = torch.empty(shape, dtype=dtype, device=dev)
        mat = pd.shape[pd.stacked:]
        draw = (mat[0], math.prod(mat[1:])) if len(mat) > 1 else mat
        if tuple(shape) == pd.shape:
            for part in out.view((-1,) + mat):
                r = torch.randn(draw, generator=generator, device=dev)
                part.copy_(r.mul_(scale).view(mat))
            return out
        cut = shard_slices(rules, spec, pd.shape)
        lead, inner = cut[:pd.stacked], cut[pd.stacked:]
        for idx in itertools.product(*map(range, pd.shape[:pd.stacked])):
            r = torch.randn(draw, generator=generator, device=dev)
            if all(s.start is None or s.start <= i < s.stop
                   for i, s in zip(idx, lead)):
                at = tuple(i - (s.start or 0) for i, s in zip(idx, lead))
                out[at].copy_(r.mul_(scale).view(mat)[inner])
        return out

    return _walk(build_schema(cfg), make)


def param_specs(cfg: ModelConfig, rules):
    """Each leaf's split over a training rank's mesh (:func:`leaf_spec`:
    ``embed_fsdp`` over ``data``; ``experts``, ``heads``, ``kv_heads``,
    ``ff``, ``vocab`` and the recurrent layers' heads over ``model``;
    each where it divides), the tree of the parameters; () everywhere
    without rules."""
    return _walk(build_schema(cfg),
                 lambda path, pd: leaf_spec(rules, path, pd))


def decode_specs(cfg: ModelConfig, rules):
    """Each leaf's split on a decode rank (``bridge.shard_decode``):
    tensor parallelism alone (``DECODE_SPLITS`` where they divide; the
    recurrent layers' leaves by heads as :func:`leaf_spec` splits them,
    their d_model dims whole)."""
    def spec(path, pd):
        if not _recurrent(path):
            return train_spec(rules, pd.axes, pd.shape, DECODE_SPLITS)
        return tuple(None if name == "embed_fsdp" else ax for ax, name in
                     zip(leaf_spec(rules, path, pd), pd.axes))

    return _walk(build_schema(cfg), spec)


def abstract_params(cfg: ModelConfig, rules=None):
    """The parameter tree as tensors on the ``meta`` device, the schema's
    shapes and dtypes without storage: what a run will hold, reckoned
    before it allocates (the JAX package's ``ShapeDtypeStruct`` tree).
    ``rules`` (a training rank's mesh): each leaf the rank's block
    (:func:`param_specs`), as ``init_params(..., rules)`` draws it."""
    def leaf(path, pd: ParamDef):
        shape = pd.shape if rules is None else shard_shape(
            rules, leaf_spec(rules, path, pd), pd.shape)
        return torch.empty(shape, dtype=TORCH_DTYPES[pd.dtype],
                           device="meta")

    return _walk(build_schema(cfg), leaf)


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(v) for v in params.values())
