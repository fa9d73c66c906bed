"""The decoder of the port: dense blocks (serial, or parallel attention and
MLP as in Command-R; the vlm family's are dense blocks with qkv bias and
M-RoPE, behind a prefix of patch embeddings), MoE blocks where every
layer's FFN is a mixture of experts (``layer_period == 1``) or every other
layer's, after a dense layer (``layer_period == 2``, Llama-4), the hybrid
family (Zamba2: Mamba2 layers with ONE shared attention block after every
``attn_period`` of them) and the ssm family (xLSTM: super-blocks of mLSTM
blocks and one sLSTM block, no attention).

Entry points:
  forward(params, batch, cfg, want_kv)      -> (logits, ForwardOut)
  loss_fn(params, batch, cfg)               -> (loss, metrics)
  prefill(params, batch, cfg)               -> (logits_last, ForwardOut)
  serve_step(params, state, cfg)            -> (logits, new_state)  1 token

Parameters are the nested dict of ``repro_torch.models.params`` (leaves
stacked over layers); the JAX package's layer ``scan`` is a Python loop,
and its scan over (dense, moe) pairs a loop over layers 0, 1, 2, ... that
takes layer i from the pair stack of its kind (``_layers``), so stacked KV
comes out in the JAX package's layer order.  Each pass takes every
stacked leaf apart once (``torch.unbind``).  When a parameter requires
grad and grad mode is on, every block runs under
``torch.utils.checkpoint``, as the JAX package wraps its scan bodies in
``jax.checkpoint``: the backward pass computes each block's activations
again from its input.  The recurrent states of the
hybrid and ssm families come out stacked in the JAX package's layout too:
``ssm.SSMState`` over all layers, or (``MLSTMState`` over (super-block,
block), ``SLSTMState`` over super-blocks).
Decode attention runs against the Harvest KV pools through
``repro_torch.core.paged_attention``.  ``serve_step`` writes the step's k
and v into the pools IN PLACE (the JAX code carries the pools through its
scan and rebuilds them with ``.at[].set``); the returned state holds the
same pool tensors, and new recurrent states.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged_attention as pa
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.moe import load_balance_loss, moe_layer
from repro_torch.models.params import (  # noqa: F401  (re-exported)
    abstract_params, build_schema, check_family, init_params, is_interleaved,
    param_count)


def _unbind(node):
    """The per-slice dicts of a dict of leaves stacked along their first
    dim: each leaf taken apart once with ``torch.unbind`` into views.  Its
    backward is one ``torch.stack`` of the slices' gradients, where
    indexing the leaf slice by slice would write a zero-filled gradient of
    the whole stacked leaf for every slice (24 x 1.89 GB for danube's
    ``wi``)."""
    if not isinstance(node, dict):
        return torch.unbind(node)
    parts = {k: _unbind(v) for k, v in node.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _layers(params):
    """Every layer's slice of the stacked layer parameters, in layer order:
    of ``params["layers"]``, or for interleaved dense/MoE pairs layer i of
    ``blocks["dense"][i // 2]`` (even i) or ``blocks["moe"][i // 2]`` (odd
    i), as ``ModelConfig.is_moe_layer`` places the MoE layers."""
    if "blocks" in params:
        dense, moe = (_unbind(params["blocks"][k]) for k in ("dense", "moe"))
        return [lp for pair in zip(dense, moe) for lp in pair]
    return _unbind(params["layers"])


def _wants_grad(params) -> bool:
    """Grad mode is on and some parameter requires grad: a training pass."""
    if not torch.is_grad_enabled():
        return False
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif node.requires_grad:
            return True
    return False


def _run(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` under ``torch.utils.checkpoint``
    (non-reentrant), which keeps only ``fn``'s inputs and computes its
    activations again in the backward pass.  The blocks draw no random
    numbers, so no RNG state is carried."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()]


def unembed(params, x, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _block(x, s, lp, cfg: ModelConfig, attend, keep_sum: bool = False):
    """One pre-LN block on the residual ``x``: attention, then the MLP or
    the MoE FFN on the second norm, or (parallel blocks) the MLP on the
    attention's own normed input, ``x + a + mlp(u)`` rounded add by add as
    the jitted JAX block rounds it (not as one f32 sum rounded once).

    ``s``: the unrounded sum that ``x`` was rounded from, where the first
    norm reads it, else None.  ``attend(u)`` -> (a, kv).  ``keep_sum``:
    return the unrounded ``x + mlp`` as the next block's ``s``; the JAX
    package scans interleaved (dense, moe) pairs in one body, where XLA
    lets the MoE layer's first norm read the dense layer's sum before its
    rounding, as it does for the second norm (``layers.residual_norm``).
    Returns (x, s, kv, the MoE layer's (probs, ids) routing or None)."""
    u = L.rms_norm(x if s is None else s, lp["ln1"], cfg.norm_eps).to(x.dtype)
    a, kv = attend(u)
    if cfg.parallel_block:
        return x + a + L.mlp(u, lp["mlp"], cfg), None, kv, None
    x, u2 = L.residual_norm(x, a, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        y, probs, ids = moe_layer(u2, lp["moe"], cfg)
        return x + y, None, kv, (probs, ids)
    y = L.mlp(u2, lp["mlp"], cfg)
    if not keep_sum:
        return x + y, None, kv, None
    s = x.float() + y.float()
    return s.to(x.dtype), s, kv, None


def _keeps_sum(cfg: ModelConfig, i: int) -> bool:
    """Layer ``i`` is the dense half of an interleaved pair."""
    return is_interleaved(cfg) and i % 2 == 0


class ForwardOut(NamedTuple):
    hidden: torch.Tensor         # (b, s, d)
    kv: Optional[Any]            # stacked (L_kv, b, s, nkv, hd) k and v
    states: Optional[Any]        # SSM / xLSTM final states
    aux: torch.Tensor            # scalar f32 aux loss (MoE load balance)


def _hybrid_layers(params, x, cfg: ModelConfig, states, single_token,
                   attend, remat: bool = False):
    """Zamba2: the Mamba2 stack with ONE shared attention block after every
    ``attn_period`` Mamba2 layers (none after the tail's).  ``states``: the
    stacked ``SSMState`` of every layer, or None (zero states);
    ``attend(j, u)`` -> (a, kv) for the shared block at super-block j.
    ``remat``: each Mamba2 layer and each shared block under
    ``torch.utils.checkpoint``.  Returns (x, the super-blocks' kv, the new
    stacked states)."""
    per = cfg.hybrid.attn_period
    shared = params["shared_attn"]
    if states is None:
        st0 = S.init_ssm_state(cfg, x.shape[0], x.device)

    def mamba(x, lp, st):
        u = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, st = S.mamba2_layer(u, lp["mamba"], cfg, st, single_token)
        return x + y, st

    def shared_block(x, j):
        return _block(x, None, shared, cfg, lambda u: attend(j, u))

    new, kvs = [], []
    for i, lp in enumerate(_unbind(params["mamba_layers"])):
        st = st0 if states is None else S.SSMState(*(t[i] for t in states))
        x, st = _run(remat, mamba, x, lp, st)
        new.append(st)
        if (i + 1) % per == 0:
            x, _, kv, _ = _run(remat, shared_block, x, i // per)
            kvs.append(kv)
    return x, kvs, S.SSMState(*(torch.stack(t) for t in zip(*new)))


def _xlstm_layers(params, x, cfg: ModelConfig, states, single_token,
                  remat: bool = False):
    """xLSTM: super-blocks of (slstm_every - 1) mLSTM blocks and one sLSTM
    block.  ``states``: (stacked ``MLSTMState`` over (super-block, block),
    stacked ``SLSTMState`` over super-blocks), or None (zero states).
    ``remat``: each block under ``torch.utils.checkpoint``.  Returns (x,
    the new states in that layout)."""
    per = cfg.xlstm.slstm_every
    supers = params["supers"]
    b = x.shape[0]
    mlstm = [_unbind(row) for row in _unbind(supers["mlstm"])]
    slstm = _unbind(supers["slstm"])
    m_new, s_new = [], []
    for j in range(cfg.num_layers // per):
        row = []
        for i in range(per - 1):
            st = X.init_mlstm_state(cfg, b, x.device) if states is None \
                else X.MLSTMState(*(t[j, i] for t in states[0]))
            x, st = _run(remat, X.mlstm_block, x, mlstm[j][i], cfg, st,
                         single_token)
            row.append(st)
        m_new.append(X.MLSTMState(*(torch.stack(t) for t in zip(*row))))
        st = X.init_slstm_state(cfg, b, x.device) if states is None \
            else X.SLSTMState(*(t[j] for t in states[1]))
        x, st = _run(remat, X.slstm_block, x, slstm[j], cfg, st,
                     single_token)
        s_new.append(st)
    return x, (X.MLSTMState(*(torch.stack(t) for t in zip(*m_new))),
               X.SLSTMState(*(torch.stack(t) for t in zip(*s_new))))


def init_states(cfg: ModelConfig, batch: int, device):
    """Zero recurrent states of ``batch`` rows, stacked over the layers as
    the model returns them (the conv tails in bf16, as the JAX package
    starts them), or None for a family without any."""
    def stacked(st, lead):
        return type(st)(*(t.expand(lead + t.shape).clone() for t in st))

    if cfg.family == "hybrid":
        return stacked(S.init_ssm_state(cfg, batch, device),
                       (cfg.num_layers,))
    if cfg.family == "ssm":
        per = cfg.xlstm.slstm_every
        ns = cfg.num_layers // per
        return (stacked(X.init_mlstm_state(cfg, batch, device),
                        (ns, per - 1)),
                stacked(X.init_slstm_state(cfg, batch, device), (ns,)))
    return None


def backbone(params, x, positions, cfg: ModelConfig, positions_3d=None,
             want_kv: bool = True) -> ForwardOut:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _wants_grad(params)
    if cfg.family == "hybrid":
        x, kvs, states = _hybrid_layers(
            params, x, cfg, None, False,
            lambda j, u: L.attention_layer(u, params["shared_attn"]["attn"],
                                           cfg, positions), remat)
        kv = tuple(torch.stack(t) for t in zip(*kvs)) if want_kv else None
        return ForwardOut(x, kv, states, aux)
    if cfg.family == "ssm":
        x, states = _xlstm_layers(params, x, cfg, None, False, remat)
        return ForwardOut(x, None, states, aux)

    def block(x, s, lp, i):
        return _block(x, s, lp, cfg,
                      lambda u: L.attention_layer(u, lp["attn"], cfg,
                                                  positions, positions_3d),
                      _keeps_sum(cfg, i))

    ks, vs = [], []
    s = None
    for i, lp in enumerate(_layers(params)):
        x, s, (k, v), routing = _run(remat, block, x, s, lp, i)
        if routing is not None:
            aux = aux + load_balance_loss(*routing, cfg.moe.num_experts)
        if want_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
    return ForwardOut(x, kv, None, aux)


def forward(params, batch, cfg: ModelConfig, want_kv: bool = False):
    """batch: dict(tokens (b, s), positions (b, npre + s)[, prefix_embeddings
    (b, npre, d), positions_3d (b, npre + s, 3)]).  A model with prefix
    embeddings (the vision frontend's patches, precomputed) reads them
    ahead of the tokens."""
    check_family(cfg)
    x = embed(params, batch["tokens"], cfg)
    if cfg.modality is not None and cfg.modality.num_prefix_embeddings:
        x = torch.cat([batch["prefix_embeddings"].to(x.dtype), x], dim=1)
    out = backbone(params, x, batch["positions"], cfg,
                   batch.get("positions_3d"), want_kv=want_kv)
    return unembed(params, out.hidden, cfg), out


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token NLL over the labelled positions (``labels >= 0``;
    the prefix positions of a vlm model cut off) plus the MoE load-balance
    loss times ``lb_loss_weight``, as ``repro.models.model.loss_fn``:
    the log-sum-exp in f32, the target logit gathered (for finite logits
    equal bit for bit to the JAX package's one-hot contraction, without a
    (b, s, V) one-hot).  batch: ``forward``'s and labels (b, s).  Returns
    (loss, {"nll", "aux"}), aux unweighted."""
    logits, out = forward(params, batch, cfg)
    labels = batch["labels"]
    npre = cfg.modality.num_prefix_embeddings if cfg.modality else 0
    if npre:
        logits = logits[:, npre:]
    if labels.dim() != logits.dim() - 1:
        raise ValueError("labels must be one rank below logits")
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1,
                       labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = torch.sum((lse - tgt) * mask) / torch.clamp(mask.sum(), min=1.0)
    aux = out.aux * (cfg.moe.lb_loss_weight if cfg.moe else 0.0)
    return nll + aux, {"nll": nll, "aux": out.aux}


def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence pass returning last-token logits + cache material."""
    logits, out = forward(params, batch, cfg, want_kv=True)
    return logits[:, -1], out


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against the Harvest-tiered KV pools
# ---------------------------------------------------------------------------


class KVPools(NamedTuple):
    """Paged KV state shared across attention layers."""
    pool_k: torch.Tensor      # (L_kv, n_slots, bs, nkv, hd)
    pool_v: torch.Tensor
    slot_req: torch.Tensor    # (n_slots,) int32, -1 = free
    slot_base: torch.Tensor   # (n_slots,) int32 first position of block
    append_slot: torch.Tensor  # (b,) int32 slot receiving this step's kv
    append_off: torch.Tensor   # (b,) int32 offset within that slot


class DecodeState(NamedTuple):
    tokens: torch.Tensor      # (b,) last emitted token
    pos: torch.Tensor         # (b,) int32 current position
    kv: Optional[KVPools]
    peer: Optional[KVPools]   # harvested peer tier (in-place mode)
    states: Optional[Any] = None                  # SSM / xLSTM states
    positions_3d: Optional[torch.Tensor] = None   # (b, 3) M-RoPE ids


def num_kv_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.attn_period
    return cfg.num_layers


def _decode_attn_sublayer(u, lp, cfg, state: DecodeState, layer: int,
                          use_peer: bool):
    """u: (b, 1, d), the normed residual. Appends this step's k/v to layer
    ``layer`` of the pools in place and returns the attention output (b,
    1, d)."""
    p3 = None if state.positions_3d is None else state.positions_3d[:, None]
    q, k, v = L.rotary_qkv(u, lp["attn"], cfg, state.pos[:, None], p3)
    kvp = state.kv
    pk, pv = kvp.pool_k[layer], kvp.pool_v[layer]
    pa.append_kv(pk, pv, k[:, 0], v[:, 0], kvp.append_slot, kvp.append_off)
    pools = [(pk, pv, kvp.slot_req, kvp.slot_base)]
    if use_peer:
        pp = state.peer
        pools.append((pp.pool_k[layer], pp.pool_v[layer], pp.slot_req,
                      pp.slot_base))
    o = pa.paged_decode_attention(q[:, 0], pools, state.pos, cfg)
    y = torch.einsum("bnh,nhd->bd", o.to(u.dtype), lp["attn"]["wo"])
    return y[:, None]


def serve_step(params, state: DecodeState, cfg: ModelConfig,
               harvest_inplace: bool = False):
    """Decode ONE token for every active request. Returns (logits, state)."""
    check_family(cfg)
    x = embed(params, state.tokens[:, None], cfg)
    use_peer = harvest_inplace and state.peer is not None
    states = state.states
    if cfg.family == "hybrid":
        x, _, states = _hybrid_layers(
            params, x, cfg, state.states, True,
            lambda j, u: (_decode_attn_sublayer(
                u, params["shared_attn"], cfg, state, j, use_peer), None))
    elif cfg.family == "ssm":
        x, states = _xlstm_layers(params, x, cfg, state.states, True)
    else:
        s = None
        for i, lp in enumerate(_layers(params)):
            x, s, _, _ = _block(
                x, s, lp, cfg, lambda u: (_decode_attn_sublayer(
                    u, lp, cfg, state, i, use_peer), None),
                _keeps_sum(cfg, i))
    logits = unembed(params, x, cfg)[:, 0]
    new_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, state._replace(tokens=new_tokens, pos=state.pos + 1,
                                  states=states)
