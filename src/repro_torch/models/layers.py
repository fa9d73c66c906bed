"""Core transformer layers of the dense decoder: RMS norm, rotary
embeddings (RoPE and Qwen2-VL's three-section M-RoPE), MusicGen's
sinusoidal positions, prefill attention (kernel K4, online softmax) and
the MLP.

Every function mirrors its namesake in ``repro.models.layers`` dtype for
dtype: bf16 operands, f32 accumulation where the JAX code asks for it, and a
rounding back to bf16 at the same places, so the two packages agree to a
bf16 rounding step.  Attention here is the prefill path (full sequence);
single-token decode against the paged KV pool lives in
``repro_torch.core.paged_attention``.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def residual_norm(x, a, scale, eps: float = 1e-5, tp=None):
    """``x + a`` and the RMS norm of it, as the JAX package computes them
    once XLA has compiled the block: the norm reads the sum before its
    rounding to x's dtype (XLA folds the bf16 round trip between the add
    and the norm's upcast away), while the residual stream keeps the
    rounded sum.  ``tp`` (a rank of tensor parallelism) splitting the
    residual: ``x`` and ``a`` are the rank's block of d_model, and the
    norm reads the unrounded sum gathered whole.  Returns (x + a, norm)."""
    s = x.float() + a.float()
    return s.to(x.dtype), rms_norm(s if tp is None else tp.whole(s), scale,
                                   eps).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    angles = angles[..., None, :]                          # over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions_3d, theta: float, sections):
    """Qwen2-VL multimodal RoPE.  positions_3d: (..., seq, 3), the (t, h,
    w) position ids; ``sections``: how many of the head_dim/2 frequency
    slots t, h and w own (their sum is head_dim // 2).  Angles in f32, one
    rounding back to x's dtype, as ``apply_rope``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    pos = positions_3d.float()                             # (..., seq, 3)
    # frequency slots of section i turn with position id i (t, h, w)
    angles = torch.cat([pos[..., i, None] * f for i, f in
                        enumerate(torch.split(freqs, list(sections)))],
                       dim=-1)[..., None, :]               # over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def position_embedding(x, positions, cfg: ModelConfig, positions_3d=None):
    if cfg.rope_style == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_style == "mrope":
        if positions_3d is None:  # text only: the three sections share pos
            positions_3d = positions[..., None].expand(
                positions.shape + (3,))
        return apply_mrope(x, positions_3d, cfg.rope_theta,
                           cfg.modality.mrope_sections)
    return x  # "none": non-rotary positions


def sinusoidal_positions(positions, d_model: int):
    """MusicGen's sinusoidal embedding of ``positions`` (..., s): an f32
    (..., s, d_model) table, the sines of the ``d_model // 2`` angles and
    then their cosines, as ``repro.models.layers.sinusoidal_positions``.
    The frequencies divide by ``half`` as a multiply by its f32
    reciprocal, which is how XLA computes the JAX package's ``/ half``.
    ``exp``, ``sin`` and ``cos`` still round otherwise than XLA's (and than
    CUDA's on the card): the f32 frequencies differ in their last bits,
    which the angle multiplies by the position, so the table agrees with
    the JAX package's to a tolerance that grows with the position, not bit
    for bit."""
    half = d_model // 2
    f32 = torch.float32
    exps = torch.arange(half, dtype=f32, device=positions.device) \
        * torch.tensor(-math.log(10_000.0), dtype=f32) \
        * torch.tensor(1.0 / half, dtype=f32)
    ang = positions[..., None].to(f32) * torch.exp(exps)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def chunked_attention(q, k, v, q_positions, k_positions, cfg: ModelConfig,
                      kv_chunk: int = 1024, logit_softcap=None):
    """Causal GQA attention with an online softmax over KV chunks, the
    masks taken from ``cfg``: the plain version of kernel K4
    (``flash_attention.ops.prefill_attention_plain``) under the JAX
    package's name.

    q: (b, sq, nq, hd);  k, v: (b, sk, nkv, hd)
    q_positions: (b, sq);  k_positions: (b, sk)
    Returns (b, sq, nq, hd) in q's dtype.
    """
    return flash.prefill_attention_plain(
        q, k, v, q_positions, k_positions,
        sliding_window=cfg.sliding_window,
        attention_chunk=cfg.attention_chunk, logit_softcap=logit_softcap,
        kv_chunk=kv_chunk)


def _project(x, p, cfg: ModelConfig, name: str):
    """One of q, k, v (``name``) of x with its bias and QK-norm: q + bq and
    k + bk stay in f32, not rounded to x's dtype (``rotary_qkv`` rotates
    them and rounds once)."""
    t = torch.einsum("bsd,dnh->bsnh", x, p["w" + name])
    if cfg.attn_bias:
        t = t + p["bv"] if name == "v" else t.float() + p["b" + name].float()
    if cfg.qk_norm and name != "v":
        t = rms_norm(t, p[name + "_norm"], cfg.norm_eps)
    return t


def attention_qkv(x, p, cfg: ModelConfig):
    """Project x -> (q, k, v) with GQA head layout and optional QK-norm.
    With a qkv bias, q + bq and k + bk come back in f32, not rounded to
    x's dtype: ``rotary_qkv`` rotates them and rounds once.  A rank of
    tensor parallelism passes its block of the weights and gets its
    heads."""
    return tuple(_project(x, p, cfg, n) for n in "qkv")


def _rotated(t, dtype, positions, cfg, positions_3d):
    return position_embedding(t, positions, cfg, positions_3d).to(dtype)


def rotary_qkv(x, p, cfg: ModelConfig, positions, positions_3d=None):
    """q, k and v of x, q and k rotated, all in x's dtype, as the jitted
    JAX sublayer computes them: XLA lets the rotary read the bias sums
    before their rounding (it folds the bf16 round trip between the add
    and the rotary's upcast away), so they round once, after it."""
    q, k, v = attention_qkv(x, p, cfg)
    return (_rotated(q, x.dtype, positions, cfg, positions_3d),
            _rotated(k, x.dtype, positions, cfg, positions_3d), v)


def _masks(cfg: ModelConfig) -> dict:
    return dict(sliding_window=cfg.sliding_window,
                attention_chunk=cfg.attention_chunk,
                logit_softcap=cfg.logit_softcap)


def attention_layer(x, p, cfg: ModelConfig, positions, positions_3d=None,
                    tp=None):
    """Full-sequence attention sublayer (prefill). Returns (y, (k, v)).

    ``tp`` (a rank of tensor parallelism, ``sharding.TensorParallel``;
    ``x`` whole along d_model) picks the JAX package's layout
    (``repro.models.layers._attn_layout``): "heads" where the q heads
    divide over the axis (column-parallel ``wq``/``wk``/``wv`` and their
    biases, K4 over the rank's q heads and the kv heads they read, a
    row-parallel ``wo`` whose f32 partial sums ``tp.out`` reduces); else
    "seq" where the sequence divides (whole weights, the rank's block of
    q rows against every key, the rows gathered back); else every rank
    computes the whole sublayer.  y comes back in the residual's layout;
    k and v are the rank's kv heads where they split, else whole."""
    if tp is None:
        q, k, v = rotary_qkv(x, p, cfg, positions, positions_3d)
        o = flash.prefill_attention(q, k, v, positions, positions,
                                    **_masks(cfg))
        return torch.einsum("bsnh,nhd->bsd", o, p["wo"]), (k, v)
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    if tp.splits("heads", nq):
        q, k, v = rotary_qkv(x, p, cfg, positions, positions_3d)
        nql = q.shape[2]
        kq, vq = flash.kv_for_heads(k, v, tp.index * nql, nql, nq // nkv,
                                    local=tp.splits("kv_heads", nkv))
        o = flash.prefill_attention(q, kq, vq, positions, positions,
                                    **_masks(cfg))
        y = row_parallel(o, p["wo"], 2)
        return tp.out(y, "partial", dtype=x.dtype), (k, v)
    s = x.shape[1]
    if s % tp.size:
        y, kv = attention_layer(x, p, cfg, positions, positions_3d)
        return tp.out(y, "whole"), kv
    rows = tp.block(s)
    p3 = None if positions_3d is None else positions_3d[:, rows]
    q = _rotated(_project(x[:, rows], p, cfg, "q"), x.dtype,
                 positions[:, rows], cfg, p3)
    k = _rotated(_project(x, p, cfg, "k"), x.dtype, positions, cfg,
                 positions_3d)
    v = _project(x, p, cfg, "v")
    o = flash.prefill_attention(q, k, v, positions[:, rows], positions,
                                **_masks(cfg))
    return tp.out(torch.einsum("bsnh,nhd->bsd", o, p["wo"]), "rows"), (k, v)


def _sigmoid(u):
    # XLA lowers jax.nn.sigmoid to 1 / (1 + exp(-u)) with every op rounded
    # in u's dtype; torch.sigmoid rounds once, which flips bf16 bits
    return 1 / (1 + torch.exp(-u))


def _silu(u):
    # jax.nn.silu is u * sigmoid(u)
    return u * _sigmoid(u)


def _gelu(u):
    # jax.nn.gelu's default tanh approximation, op for op, each op rounded
    # in u's dtype; its constants are weakly typed in JAX, so they round
    # to u's dtype first (a Python float would multiply at f32).  In bf16
    # this equals the jitted JAX gelu on every bf16 input above 1e-36 (XLA
    # on the CPU flushes the subnormals below to zero); in f32 it differs
    # by XLA's own tanh, a rational approximation, a few f32 ulp apart
    c = torch.tensor((2 / math.pi) ** 0.5, dtype=u.dtype)
    k = torch.tensor(0.044715, dtype=u.dtype)
    return u * (0.5 * (1 + torch.tanh(c * (u + k * (u * u * u)))))


def _relu2(u):  # nemotron squared relu
    return torch.square(torch.relu(u))


def _activation(name: str):
    acts = {"silu": _silu, "gelu": _gelu, "relu2": _relu2}
    if name not in acts:
        raise ValueError(name)
    return acts[name]


def _mlp_hidden(x, p, cfg: ModelConfig):
    act = _activation(cfg.activation)
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.gated_mlp:
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        return act(g) * h
    return act(h)


class _F32Product(torch.autograd.Function):
    """``a @ w`` of bf16 operands with f32 accumulation and an f32 output
    (``torch.mm(..., out_dtype=)``: cuBLAS's bf16 product on the card, its
    shape on ``meta``), which has no derivative of its own.  The CPU has
    no such product: there the operands are widened (the same sums), and
    an op counter on the dispatch-mode stack counts the card's product in
    their place.  The backward multiplies in the operands' dtype: the
    gradient that reaches it is the widened gradient of the sum's rounding
    to that dtype (``TensorParallel.out``), so narrowing it is exact."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if a.device.type != "cpu":
            return torch.mm(a, w, out_dtype=torch.float32)
        counters = [m for m in _get_current_dispatch_mode_stack()
                    if hasattr(m, "count_as")]
        with contextlib.ExitStack() as stack:
            for c in counters:
                stack.enter_context(c.inside_kernel())
            y = a.float() @ w.float()
        for c in counters:
            c.count_as(torch.ops.aten.mm.dtype, (a, w),
                       {"out_dtype": torch.float32}, y)
        return y

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ w.t() if ctx.needs_input_grad[0] else None,
                a.t() @ g if ctx.needs_input_grad[1] else None)


def row_parallel(a, w, k: int):
    """One rank's share of a row-parallel product, in f32: ``a``'s last
    ``k`` dims contracted with ``w``'s first ``k`` (``bsnh,nhd->bsd``,
    ``bsf,fd->bsd``), so that the ranks' shares are summed unrounded and
    the sum rounds once to its dtype, as the unsplit product's f32
    accumulation does (and as the JAX package's sharded program sums its
    f32 partials).  A bf16 model's product runs in bf16 with an f32
    output (``_F32Product``), counted alike on every device."""
    lead, inner = a.shape[:a.dim() - k], w.shape[k:]
    a2 = a.reshape(math.prod(lead), -1)
    w2 = w.reshape(a2.shape[1], -1)
    if a2.dtype == torch.float32:
        y = a2 @ w2
    else:
        y = _F32Product.apply(a2, w2)
    return y.view(*lead, *inner)


def mlp(x, p, cfg: ModelConfig, tp=None, d_ff=None):
    """The MLP.  ``tp`` (a rank of tensor parallelism; ``x`` whole along
    d_model): where the hidden dim (``d_ff``, the config's unless given)
    splits, column-parallel ``wi``/``wg``/``bi`` and a row-parallel
    ``wo`` whose partial sums ``tp.out`` reduces, ``bo`` added once after
    the sum; else every rank computes it whole.  The output comes back in
    the residual's layout."""
    if tp is not None:
        if tp.splits("ff", cfg.d_ff if d_ff is None else d_ff):
            y = row_parallel(_mlp_hidden(x, p, cfg), p["wo"], 1)
            return tp.out(y, "partial", p["bo"] if cfg.mlp_bias else None,
                          dtype=x.dtype)
        return tp.out(mlp(x, p, cfg), "whole")
    y = torch.einsum("bsf,fd->bsd", _mlp_hidden(x, p, cfg), p["wo"])
    if cfg.mlp_bias:
        y = y + p["bo"]
    return y
