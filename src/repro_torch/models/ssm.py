"""Mamba2 (SSD) selective state-space layer: the unsharded path of
``repro.models.ssm``.

Prefill uses the chunked SSD algorithm (intra-chunk quadratic form plus the
inter-chunk state recurrence, the JAX package's ``lax.scan`` over chunks a
loop here); decode uses the O(1) single-token recurrence.  The recurrent
state is the "reconstructible transient state" case of the Harvest
durability model: a preempted request rebuilds it by re-running its
prefill.  There is no Pallas kernel for these layers in the JAX package:
they are plain PyTorch on every device.

Shapes follow the Mamba2 paper with ngroups=1:
  d_inner = expand * d_model,  nheads = d_inner // head_dim
  state S: (b, nheads, head_dim, state_dim)

Under tensor parallelism a rank whose leaves hold its heads alone
(``params.leaf_spec``) runs the layer over them: the leaves are its block
(``params.mamba_schema``), the state its heads' and the conv tail its
channels (its x channels, every B and C channel).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import (TENSOR_PARALLEL, sum_grad_over,
                                          sum_over, tagged)
from repro_torch.models.layers import _silu, rms_norm, row_parallel


class SSMState(NamedTuple):
    s: torch.Tensor        # (b, nh, hd, N) f32: the SSM state
    conv: torch.Tensor     # (b, W-1, conv_dim): the causal conv's tail


def ssm_dims(cfg: ModelConfig, heads: Optional[int] = None):
    """(d_inner, nheads, conv_dim) of the layer, or of ``heads`` of its
    heads (a rank's share: their x channels and every B and C)."""
    sc = cfg.ssm
    nheads = sc.expand * cfg.d_model // sc.head_dim if heads is None \
        else heads
    d_inner = nheads * sc.head_dim
    conv_dim = d_inner + 2 * sc.state_dim      # x, B, C go through the conv
    return d_inner, nheads, conv_dim


def softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` for every x
    (``torch.nn.functional.softplus`` returns x itself past its threshold
    of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u, w, b, tail=None):
    """Depthwise causal conv1d.  u: (b, s, c);  w: (W, c);  tail: (b, W-1,
    c).  ``torch.cat`` promotes a bf16 tail and f32 input to f32 as
    ``jnp.concatenate`` does."""
    W = w.shape[0]
    if tail is None:
        tail = u.new_zeros(u.shape[:1] + (W - 1,) + u.shape[2:])
    up = torch.cat([tail, u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(W))
    new_tail = up[:, up.shape[1] - (W - 1):]
    return _silu(out + b), new_tail


def _ssd_chunked(xh, dt, A, B, C, chunk: int, s0=None):
    """Chunked SSD scan.

    xh: (b, s, nh, hd)   dt: (b, s, nh)   A: (nh,)  B, C: (b, s, N)
    Returns (y: (b, s, nh, hd) f32, final state (b, nh, hd, N) f32).
    The intra-chunk product is formed as (b, i, j, nh) weights times x,
    never as one (b, i, j, nh, hd) tensor.
    """
    b, s, nh, hd = xh.shape
    N = B.shape[-1]
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s
    f32 = torch.float32

    def chunked(t):
        t = F.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((b, nchunks, chunk) + t.shape[2:])

    xc, dtc, Bc, Cc = chunked(xh), chunked(dt), chunked(B), chunked(C)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    S = s0 if s0 is not None else torch.zeros((b, nh, hd, N), dtype=f32,
                                              device=xh.device)
    ys = []
    for c in range(nchunks):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dtq * A, dim=1)                 # (b,q,nh) log-decay
        # intra-chunk: L[i,j] = exp(cum_i - cum_j), j <= i.  The masked
        # (j > i) differences are set to -inf before the exp, not after:
        # they grow with the chunk past exp's range, and an inf there,
        # selected away, would still give a NaN gradient (0 * inf); the
        # values are the JAX package's ``where(mask, exp(diff), 0)``
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (b,i,j,nh)
        Lm = torch.exp(torch.where(mask[None, :, :, None], diff,
                                   float("-inf")))
        CB = torch.einsum("bin,bjn->bij", Cq, Bq)
        w = Lm * CB[..., None] * dtq[:, None]              # (b,i,j,nh)
        y_intra = torch.einsum("bijh,bjhd->bihd", w, xq)
        # inter-chunk contribution from the carried state
        y_inter = torch.einsum("bin,bhdn->bihd", Cq, S) \
            * torch.exp(cum)[..., None]
        # state update
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)     # (b,q,nh)
        S_local = torch.einsum("bjhd,bjn->bhdn",
                               (decay_to_end * dtq)[..., None] * xq, Bq)
        S = S * torch.exp(cum[:, -1, :])[..., None, None] + S_local
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y[:, :s], S


def _gated_norm(g, scale, eps: float, width: int, tp):
    """The RMS norm of the f32 ``g`` (b, s, the rank's channels) over all
    ``width`` channels of the ranks of ``tp``: each rank's f32 sum of
    squares summed over them, whose gradient sums the ranks' cotangents
    (each consumes the sum for its own channels)."""
    ss = torch.sum(torch.square(g), dim=-1, keepdim=True)
    with tagged(TENSOR_PARALLEL):
        ss = sum_grad_over(sum_over(ss, tp.group), tp.group)
    return (g * torch.rsqrt(ss / width + eps)) * scale.float()


def mamba2_layer(x, p, cfg: ModelConfig,
                 state: Optional[SSMState] = None, single_token: bool = False,
                 tp=None) -> Tuple[torch.Tensor, SSMState]:
    """Mamba2 sublayer.  x: (b, s, d).  Returns (y, new_state).

    ``tp`` (a rank of tensor parallelism; ``x`` whole along d_model): y
    comes back in the residual's layout.  Where ``p`` holds the rank's
    heads alone (``params.mamba_schema``, as ``params.leaf_spec`` splits
    it; ``state`` theirs too) the layer computes them: the gated norm's
    sum of squares summed over the axis, ``out_proj`` row-parallel, its
    f32 partial sums reduced by ``tp.out``; else the whole layer, its
    output cut."""
    sc = cfg.ssm
    d_all, nh_all, _ = ssm_dims(cfg)
    split = p["norm"].shape[-1] < d_all
    d_inner, nheads, conv_dim = ssm_dims(
        cfg, p["norm"].shape[-1] // sc.head_dim)
    b, s, d = x.shape
    f32 = torch.float32
    per_head = [p[k] for k in ("dt_bias", "A_log", "D")]
    if split:
        per_head = [t[tp.block(nh_all)] for t in per_head]
    dt_bias, A_log, D = per_head

    zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, nheads], dim=-1)
    dt = softplus(dt.float() + dt_bias.float())

    conv_tail = state.conv if state is not None else None
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xs, B, C = torch.split(xbc, [d_inner, sc.state_dim, sc.state_dim],
                           dim=-1)
    xh = xs.reshape(b, s, nheads, sc.head_dim)

    A = -torch.exp(A_log.float())                          # (nh,)
    s_prev = state.s if state is not None else None

    if single_token:
        # O(1) recurrence: S = S * exp(dt A) + dt B x ; y = C S
        dt1 = dt[:, 0]                                     # (b, nh)
        dA = torch.exp(dt1 * A[None, :])
        if s_prev is None:
            s_prev = torch.zeros((b, nheads, sc.head_dim, sc.state_dim),
                                 dtype=f32, device=x.device)
        Bx = (dt1[:, :, None, None] * B[:, 0].float()[:, None, None, :]) \
            * xh[:, 0].float()[..., None]
        S = s_prev * dA[..., None, None] + Bx
        y = torch.einsum("bn,bhdn->bhd", C[:, 0].float(), S)[:, None]
    else:
        y, S = _ssd_chunked(xh, dt, A, B.float(), C.float(), sc.chunk_size,
                            s_prev)

    y = y + xh.float() * D.float()[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z)), the product read before
    # its rounding to x's dtype, as the jitted JAX layer computes it (XLA
    # folds the round trip between the multiply and the norm's upcast)
    g = y.float() * _silu(z).float()
    new = SSMState(s=S, conv=new_tail)
    if split:
        y = _gated_norm(g, p["norm"], cfg.norm_eps, nh_all * sc.head_dim,
                        tp).to(x.dtype)
        return tp.out(row_parallel(y, p["out_proj"], 1), "partial",
                      dtype=x.dtype), new
    y = rms_norm(g, p["norm"], cfg.norm_eps).to(x.dtype)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return (out if tp is None else tp.out(out, "whole")), new


def init_ssm_state(cfg: ModelConfig, batch: int, device,
                   heads: Optional[int] = None) -> SSMState:
    """Zero state (of ``heads`` of the heads, all by default): ``s`` in
    f32, the conv tail in bf16 whatever the weights' dtype, as the JAX
    package starts it."""
    sc = cfg.ssm
    d_inner, nheads, conv_dim = ssm_dims(cfg, heads)
    return SSMState(
        s=torch.zeros((batch, nheads, sc.head_dim, sc.state_dim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, sc.conv_width - 1, conv_dim),
                         dtype=torch.bfloat16, device=device),
    )
