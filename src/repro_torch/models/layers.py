"""Core transformer layers of the dense decoder: RMS norm, rotary
embeddings, memory-bounded (chunked, online-softmax) attention and the MLP.

Every function mirrors its namesake in ``repro.models.layers`` dtype for
dtype: bf16 operands, f32 accumulation where the JAX code asks for it, and a
rounding back to bf16 at the same places, so the two packages agree to a
bf16 rounding step.  Attention here is the prefill path (full sequence);
single-token decode against the paged KV pool lives in
``repro_torch.core.paged_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


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


def position_embedding(x, positions, cfg: ModelConfig):
    if cfg.rope_style == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    raise NotImplementedError(
        f"rope_style {cfg.rope_style!r} belongs to a later slice of the port")


def _band_mask(q_pos, k_pos, cfg: ModelConfig):
    """(..., q, k) boolean mask combining causal + sliding-window +
    chunked-local; leading dims of ``q_pos``/``k_pos`` batch over."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    m = kp <= qp                                           # causal
    if cfg.sliding_window is not None:
        m &= kp > (qp - cfg.sliding_window)
    if cfg.attention_chunk is not None:                    # chunked local
        c = cfg.attention_chunk
        m &= torch.div(kp, c, rounding_mode="floor") == \
            torch.div(qp, c, rounding_mode="floor")
    return m


def chunked_attention(q, k, v, q_positions, k_positions, cfg: ModelConfig,
                      kv_chunk: int = 1024, logit_softcap=None):
    """Causal GQA attention with an online softmax over KV chunks.

    q: (b, sq, nq, hd);  k, v: (b, sk, nkv, hd)
    q_positions: (b, sq);  k_positions: (b, sk)
    Returns (b, sq, nq, hd) in q's dtype.

    The grouped layout of the JAX path without a mesh: q is folded to
    (b, sq, nkv, gq, hd); products take the working-dtype operands and sum
    in f32, and the probabilities are rounded to v's dtype before the
    second product, as ``preferred_element_type=f32`` does there.
    """
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gq = nq // nkv
    scale = hd ** -0.5

    kv_chunk = min(kv_chunk, sk)
    n_chunks = -(-sk // kv_chunk)
    pad = n_chunks * kv_chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=-(10 ** 9))

    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, sq, nkv, gq, hd)
    qf = qf.float()
    m = torch.full((b, sq, nkv, gq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, nkv, gq, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kj, vj, posj = k[:, sl], v[:, sl], k_positions[:, sl]
        mask = _band_mask(q_positions, posj, cfg)           # (b, sq, C)
        s = torch.einsum("bqKgh,bcKh->bqKgc", qf, kj.float())
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        upd = torch.einsum("bqKgc,bcKh->bqKgh", p.to(vj.dtype).float(),
                           vj.float())
        acc = acc * corr[..., None] + upd
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, nq, hd).to(q.dtype)


def attention_qkv(x, p, cfg: ModelConfig):
    """Project x -> (q, k, v) with GQA head layout and optional QK-norm."""
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_layer(x, p, cfg: ModelConfig, positions):
    """Full-sequence attention sublayer (prefill). Returns (y, (k, v))."""
    q, k, v = attention_qkv(x, p, cfg)
    q = position_embedding(q, positions, cfg)
    k = position_embedding(k, positions, cfg)
    o = chunked_attention(q, k, v, positions, positions, cfg,
                          logit_softcap=cfg.logit_softcap)
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
    # jax.nn.gelu's default tanh approximation, op for op (agrees with the
    # jitted JAX MLP to a bf16 rounding step)
    c = torch.tensor((2 / torch.pi) ** 0.5, dtype=u.dtype)
    return u * (0.5 * (1 + torch.tanh(c * (u + 0.044715 * (u * u * u)))))


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
