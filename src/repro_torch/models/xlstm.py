"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan with exponential gating); the
unsharded path of ``repro.models.xlstm``.

mLSTM uses the stabilized chunkwise form (log-space gate accumulation with a
running max ``m``), carrying only chunk-boundary states.  The single-step
recurrence (``mlstm_step``) is the decode path and the oracle the chunkwise
form is tested against.  The JAX package's scans are loops here.  On a
mesh each rank runs these blocks over its own rows (``models.model``),
which is what the JAX package's sLSTM ``shard_map`` over the batch does;
the gradient of ``w_rec``, reduced once at that region's exit there, is
summed over the batch's ranks once a step with the other leaves no axis
splits (``train.optim._sync_grads``).  Under tensor parallelism a rank
whose leaves hold its heads alone (``params.leaf_spec``) runs them: its
block of the leaves (``params.mlstm_schema``, ``slstm_schema``), its
heads' states and its channels' conv tail.  There is no Pallas kernel for
these blocks in the JAX package: they are plain PyTorch on every device.

Recurrent state is Harvest's "lossy + reconstructible" durability class.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import (TENSOR_PARALLEL, reduce_scatter,
                                          tagged)
from repro_torch.models.layers import (_gelu, _silu, residual_norm, rms_norm,
                                       row_parallel)
from repro_torch.models.ssm import softplus

LOG_EPS = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (b, nh, hd, hd) f32 stabilized matrix memory
    n: torch.Tensor   # (b, nh, hd) f32 normalizer
    m: torch.Tensor   # (b, nh) f32 running log-max
    conv: torch.Tensor  # (b, W-1, d_inner) conv tail


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (b, nh, hd)
    n: torch.Tensor   # (b, nh, hd)
    m: torch.Tensor   # (b, nh, hd)
    h: torch.Tensor   # (b, nh, hd)


def xlstm_dims(cfg: ModelConfig):
    xc = cfg.xlstm
    d_inner = int(cfg.d_model * xc.proj_factor_mlstm)
    nh = cfg.num_heads
    hd = d_inner // nh
    return d_inner, nh, hd


def slstm_dims(cfg: ModelConfig):
    """An sLSTM block's (heads, head width, GEGLU hidden width)."""
    nh, d = cfg.num_heads, cfg.d_model
    return nh, d // nh, int(d * cfg.xlstm.proj_factor_slstm)


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def mlstm_step(q, k, v, i_raw, f_raw, state: MLSTMState):
    """Single-token stabilized mLSTM recurrence (decode path + oracle).

    q,k,v: (b, nh, hd);  i_raw,f_raw: (b, nh).
    """
    q, k, v = q.float(), k.float(), v.float()
    hd = q.shape[-1]
    i_raw = i_raw.float()
    logf = log_sigmoid(f_raw.float())
    m_new = torch.maximum(logf + state.m, i_raw)
    f_s = torch.exp(logf + state.m - m_new)
    i_s = torch.exp(i_raw - m_new)
    k_sc = k / (hd ** 0.5)
    c_new = state.c * f_s[..., None, None] + i_s[..., None, None] * (
        k_sc[..., :, None] * v[..., None, :])
    n_new = state.n * f_s[..., None] + i_s[..., None] * k_sc
    num = torch.einsum("bnh,bnhd->bnd", q, c_new)
    denom = torch.maximum(torch.einsum("bnh,bnh->bn", q, n_new).abs(),
                          torch.exp(-m_new))
    h = num / denom[..., None]
    return h, MLSTMState(c_new, n_new, m_new, state.conv)


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state: Optional[MLSTMState],
                    chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM.

    q,k,v: (b, s, nh, hd);  i_raw,f_raw: (b, s, nh).
    Returns (h: (b, s, nh, hd) f32, final (c, n, m)).
    """
    f32 = torch.float32
    b, s, nh, hd = q.shape
    chunk = min(chunk, s)
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s

    def chunked(x, value=0.0):
        x = x.to(f32)
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value)
        return x.reshape((b, nchunks, chunk) + x.shape[2:])

    qc, kc, vc = chunked(q), chunked(k), chunked(v)
    ic, fc = chunked(i_raw, LOG_EPS), chunked(f_raw, 30.0)
    kc = kc / (hd ** 0.5)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))

    if state is None:
        C_prev = torch.zeros((b, nh, hd, hd), dtype=f32, device=q.device)
        n_prev = torch.zeros((b, nh, hd), dtype=f32, device=q.device)
        m_prev = torch.full((b, nh), LOG_EPS, dtype=f32, device=q.device)
    else:
        C_prev, n_prev, m_prev = state.c, state.n, state.m
    hs = []
    for c in range(nchunks):
        qq, kk, vv, ii, ff = qc[:, c], kc[:, c], vc[:, c], ic[:, c], fc[:, c]
        logf = log_sigmoid(ff)
        bcum = torch.cumsum(logf, dim=1)           # (b,q,nh)
        btot = bcum[:, -1]                         # (b,nh)
        # intra log weights D[i,j] = bcum_i - bcum_j + ilog_j  (j <= i)
        D = bcum[:, :, None, :] - bcum[:, None, :, :] + ii[:, None, :, :]
        D = torch.where(causal[None, :, :, None], D, LOG_EPS)
        # inter log weight g_i = bcum_i + m_prev
        g = bcum + m_prev[:, None, :]
        m_i = torch.maximum(D.amax(dim=2), g)      # (b,q,nh)
        S = torch.einsum("binh,bjnh->bijn", qq, kk) \
            * torch.exp(D - m_i[:, :, None, :])
        num = torch.einsum("bijn,bjnh->binh", S, vv)
        num = num + torch.einsum("binh,bnhd->bind", qq, C_prev) \
            * torch.exp(g - m_i)[..., None]
        nrm = S.sum(dim=2) + torch.einsum("binh,bnh->bin", qq, n_prev) \
            * torch.exp(g - m_i)
        hs.append(num / torch.maximum(nrm.abs(), torch.exp(-m_i))[..., None])
        # state update
        w = btot[:, None, :] - bcum + ii           # (b,q,nh) log weight per j
        m_new = torch.maximum(btot + m_prev, w.amax(dim=1))
        scale_prev = torch.exp(btot + m_prev - m_new)
        wts = torch.exp(w - m_new[:, None, :])
        C_prev = C_prev * scale_prev[..., None, None] + torch.einsum(
            "bjnh,bjnd->bnhd", wts[..., None] * kk, vv)
        n_prev = n_prev * scale_prev[..., None] \
            + torch.einsum("bjn,bjnh->bnh", wts, kk)
        m_prev = m_new
    h = torch.cat(hs, dim=1)[:, :s]
    return h, (C_prev, n_prev, m_prev)


def _alike(block, x, p, cfg, state, single_token, tp):
    """``block`` whole on every rank of ``tp``: on the gathered stream, its
    output cut to the residual's layout."""
    y, state = block(tp.whole(x), p, cfg, state, single_token)
    return tp.shard(y), state


def mlstm_block(x, p, cfg: ModelConfig, state: Optional[MLSTMState] = None,
                single_token: bool = False, tp=None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """Full mLSTM block: LN -> up-proj -> conv -> qkv -> cell -> gate ->
    down.  ``tp`` (a rank of tensor parallelism): ``x`` and the output in
    the residual's layout; where ``p`` holds the rank's heads alone (as
    ``params.leaf_spec`` splits it; ``state`` theirs too): the gates'
    partial sums over its channels reduce-scattered to its heads' (i, f)
    pairs, ``w_down`` row-parallel (``out_norm`` is per head); else the
    block whole on every rank."""
    _, nh_all, hd = xlstm_dims(cfg)
    nh = p["wq"].shape[0]
    if tp is not None and nh == nh_all:
        return _alike(mlstm_block, x, p, cfg, state, single_token, tp)
    d_inner = nh * hd
    b, s, _ = x.shape
    u = rms_norm(x if tp is None else tp.whole(x), p["ln"], cfg.norm_eps)
    up = torch.einsum("bsd,dk->bsk", u, p["w_up"])   # (b, s, 2*d_inner)
    xm, z = torch.chunk(up, 2, dim=-1)

    # causal depthwise conv feeding q/k
    W = p["conv_w"].shape[0]
    tail = state.conv if state is not None \
        else x.new_zeros((b, W - 1, d_inner))
    xp = torch.cat([tail, xm], dim=1)
    conv = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(W))
    conv = _silu(conv + p["conv_b"])
    new_tail = xp[:, xp.shape[1] - (W - 1):]

    def heads(t, w):  # per-head block-diagonal projection
        return torch.einsum("bsnh,nhk->bsnk", t.reshape(b, s, nh, hd), w)

    q = heads(conv, p["wq"])
    k = heads(conv, p["wk"])
    v = heads(xm, p["wv"])
    if tp is None:
        gates = torch.einsum("bsk,kg->bsg", xm, p["w_gates"]) + p["b_gates"]
    else:
        with tagged(TENSOR_PARALLEL):
            part = reduce_scatter([row_parallel(xm, p["w_gates"], 1)], [2],
                                  tp.group)[0]
        gates = part.to(x.dtype) + p["b_gates"][tp.block(2 * nh_all)]
    i_raw, f_raw = gates.reshape(b, s, nh, 2).unbind(-1)

    if single_token:
        st = state if state is not None else init_mlstm_state(cfg, b,
                                                              x.device, nh)
        h, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                                  i_raw[:, 0], f_raw[:, 0], st)
        h = h[:, None]
        new_state = MLSTMState(new_state.c, new_state.n, new_state.m,
                               new_tail)
    else:
        h, (cf, nf, mf) = mlstm_chunkwise(q, k, v, i_raw, f_raw, state)
        new_state = MLSTMState(cf, nf, mf, new_tail)

    h = rms_norm(h.to(x.dtype), p["out_norm"], cfg.norm_eps)
    h = h.reshape(b, s, d_inner) * _silu(z)
    if tp is None:
        return x + torch.einsum("bsk,kd->bsd", h, p["w_down"]), new_state
    y = tp.out(row_parallel(h, p["w_down"], 1), "partial", dtype=x.dtype)
    return x + y, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_cell(carry, g_t, w_rec):
    """One token of the exp-gated scalar cell.  g_t: (b, nh, 4, hd) input
    contributions of the (z, i, f, o) gates; w_rec in f32."""
    c, n, m, h_prev = carry
    # recurrent contribution (block-diagonal per head)
    gr = torch.einsum("bnh,nhgk->bngk", h_prev, w_rec)
    g = g_t.float() + gr
    z_t = torch.tanh(g[:, :, 0])
    i_t = g[:, :, 1]
    f_t = g[:, :, 2]
    o_t = torch.sigmoid(g[:, :, 3])
    logf = log_sigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * z_t
    n_new = f_s * n + i_s
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def slstm_block(x, p, cfg: ModelConfig, state: Optional[SLSTMState] = None,
                single_token: bool = False, tp=None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """sLSTM block: LN -> sequential exp-gated scalar cell -> GN -> GEGLU
    MLP.  ``tp`` (a rank of tensor parallelism): ``x`` and the output in
    the residual's layout; where ``p`` holds the rank's heads alone (as
    ``params.leaf_spec`` splits it; ``state`` theirs too), whose cells
    alone it runs, ``w_out`` row-parallel (the residual norm then reads
    the f32 sum gathered where the residual is split), and the MLP by
    columns and rows where ``p`` holds its block of the hidden width too,
    else whole; where ``p`` holds every head, the block whole on every
    rank."""
    nh_all, _, f2 = slstm_dims(cfg)
    if tp is not None and p["w_rec"].shape[0] == nh_all:
        return _alike(slstm_block, x, p, cfg, state, single_token, tp)
    b, s, _ = x.shape
    u = rms_norm(x if tp is None else tp.whole(x), p["ln"], cfg.norm_eps)
    # input contributions for 4 gates (z, i, f, o): (b, s, nh, 4, hd)
    gx = torch.einsum("bsd,dngk->bsngk", u, p["w_in"]) + p["b_in"]

    if state is None:
        state = init_slstm_state(cfg, b, x.device, p["w_rec"].shape[0])
    carry = tuple(state)
    w_rec = p["w_rec"].float()
    hs = []
    for t in range(1 if single_token else s):
        carry = _slstm_cell(carry, gx[:, t], w_rec)
        hs.append(carry[3])
    hs = torch.stack(hs, dim=1)
    new_state = SLSTMState(*carry)

    hs = rms_norm(hs.to(x.dtype), p["gn"], cfg.norm_eps)
    a = torch.einsum("bsnh,nhd->bsd", hs, p["w_out"]) if tp is None else \
        tp.out(row_parallel(hs, p["w_out"], 2), "partial", dtype=x.dtype)
    y, u2 = residual_norm(x, a, p["ln2"], cfg.norm_eps, tp)

    # post GEGLU MLP (proj factor 4/3)
    hh = torch.einsum("bsd,df->bsf", u2, p["mlp_wi"])
    gg = torch.einsum("bsd,df->bsf", u2, p["mlp_wg"])
    act = _gelu(gg) * hh
    if tp is None:
        return y + torch.einsum("bsf,fd->bsd", act, p["mlp_wo"]), new_state
    if p["mlp_wo"].shape[0] < f2:
        m = tp.out(row_parallel(act, p["mlp_wo"], 1), "partial", dtype=x.dtype)
    else:
        m = tp.out(torch.einsum("bsf,fd->bsd", act, p["mlp_wo"]), "whole")
    return y + m, new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     heads: Optional[int] = None) -> MLSTMState:
    """Zero state (of ``heads`` of the heads, all by default), ``m`` at
    LOG_EPS; the conv tail in bf16 whatever the weights' dtype, as the JAX
    package starts it."""
    d_inner, nh, hd = xlstm_dims(cfg)
    if heads is not None:
        nh, d_inner = heads, heads * hd
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, nh, hd), dtype=f32, device=device),
        m=torch.full((batch, nh), LOG_EPS, dtype=f32, device=device),
        conv=torch.zeros((batch, cfg.xlstm.conv_width - 1, d_inner),
                         dtype=torch.bfloat16, device=device),
    )


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     heads: Optional[int] = None) -> SLSTMState:
    """Zero state (of ``heads`` of the heads, all by default), ``m`` at
    LOG_EPS."""
    nh_all, hd, _ = slstm_dims(cfg)
    nh = nh_all if heads is None else heads
    z = torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, m=torch.full_like(z, LOG_EPS), h=z)
