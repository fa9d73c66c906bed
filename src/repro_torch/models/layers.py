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

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def residual_norm(x, a, scale, eps: float = 1e-5):
    """``x + a`` and the RMS norm of it, as the JAX package computes them
    once XLA has compiled the block: the norm reads the sum before its
    rounding to x's dtype (XLA folds the bf16 round trip between the add
    and the norm's upcast away), while the residual stream keeps the
    rounded sum.  Returns (x + a, norm)."""
    s = x.float() + a.float()
    return s.to(x.dtype), rms_norm(s, scale, eps).to(x.dtype)


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


def attention_qkv(x, p, cfg: ModelConfig):
    """Project x -> (q, k, v) with GQA head layout and optional QK-norm.
    With a qkv bias, q + bq and k + bk come back in f32, not rounded to
    x's dtype: ``rotary_qkv`` rotates them and rounds once."""
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    if cfg.attn_bias:
        q = q.float() + p["bq"].float()
        k = k.float() + p["bk"].float()
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def rotary_qkv(x, p, cfg: ModelConfig, positions, positions_3d=None):
    """q, k and v of x, q and k rotated, all in x's dtype, as the jitted
    JAX sublayer computes them: XLA lets the rotary read the bias sums
    before their rounding (it folds the bf16 round trip between the add
    and the rotary's upcast away), so they round once, after it."""
    q, k, v = attention_qkv(x, p, cfg)
    q = position_embedding(q, positions, cfg, positions_3d).to(x.dtype)
    k = position_embedding(k, positions, cfg, positions_3d).to(x.dtype)
    return q, k, v


def attention_layer(x, p, cfg: ModelConfig, positions, positions_3d=None):
    """Full-sequence attention sublayer (prefill). Returns (y, (k, v))."""
    q, k, v = rotary_qkv(x, p, cfg, positions, positions_3d)
    o = flash.prefill_attention(
        q, k, v, positions, positions,
        sliding_window=cfg.sliding_window,
        attention_chunk=cfg.attention_chunk, logit_softcap=cfg.logit_softcap)
    y = torch.einsum("bsnh,nhd->bsd", o, p["wo"])
    return y, (k, v)


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


def mlp(x, p, cfg: ModelConfig):
    act = _activation(cfg.activation)
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.gated_mlp:
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        h = act(g) * h
    else:
        h = act(h)
    y = torch.einsum("bsf,fd->bsd", h, p["wo"])
    if cfg.mlp_bias:
        y = y + p["bo"]
    return y
