"""The decoder of the port: dense blocks (serial, or parallel attention and
MLP as in Command-R; the vlm family's are dense blocks with qkv bias and
M-RoPE, behind a prefix of patch embeddings), and MoE blocks where every
layer's FFN is a mixture of experts (``layer_period == 1``) or every other
layer's, after a dense layer (``layer_period == 2``, Llama-4).

Entry points:
  forward(params, batch, cfg, want_kv)      -> (logits, ForwardOut)
  prefill(params, batch, cfg)               -> (logits_last, ForwardOut)
  serve_step(params, state, cfg)            -> (logits, new_state)  1 token

Parameters are the nested dict of ``repro_torch.models.params`` (leaves
stacked over layers); the JAX package's layer ``scan`` is a Python loop,
and its scan over (dense, moe) pairs a loop over layers 0, 1, 2, ... that
takes layer i from the pair stack of its kind (``_layer``), so stacked KV
comes out in the JAX package's layer order.
Decode attention runs against the Harvest KV pools through
``repro_torch.core.paged_attention``.  ``serve_step`` writes the step's k
and v into the pools IN PLACE (the JAX code carries the pools through its
scan and rebuilds them with ``.at[].set``); the returned state holds the
same pool tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged_attention as pa
from repro_torch.models import layers as L
from repro_torch.models.moe import load_balance_loss, moe_layer
from repro_torch.models.params import (  # noqa: F401  (re-exported)
    build_schema, check_family, init_params, is_interleaved, param_count)


def _layer(params, i: int):
    """Layer ``i``'s slice of the stacked layer parameters: of
    ``params["layers"]``, or for interleaved dense/MoE pairs of
    ``blocks["dense"][i // 2]`` (even i) or ``blocks["moe"][i // 2]`` (odd
    i), as ``ModelConfig.is_moe_layer`` places the MoE layers."""
    def pick(node, j):
        return {k: pick(v, j) for k, v in node.items()} \
            if isinstance(node, dict) else node[j]
    if "blocks" in params:
        return pick(params["blocks"]["moe" if i % 2 else "dense"], i // 2)
    return pick(params["layers"], i)


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


def _residual_norm(x, a, scale, cfg: ModelConfig):
    """``x + a`` and the RMS norm of it, as the JAX package computes them
    once XLA has compiled the block: the norm reads the sum before its
    rounding to x's dtype (XLA folds the bf16 round trip between the add
    and the norm's upcast away), while the residual stream keeps the
    rounded sum.  Returns (x + a, norm)."""
    s = x.float() + a.float()
    return s.to(x.dtype), L.rms_norm(s, scale, cfg.norm_eps).to(x.dtype)


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
    rounding, as it does for the second norm (``_residual_norm``).
    Returns (x, s, kv, the MoE layer's (probs, ids) routing or None)."""
    u = L.rms_norm(x if s is None else s, lp["ln1"], cfg.norm_eps).to(x.dtype)
    a, kv = attend(u)
    if cfg.parallel_block:
        return x + a + L.mlp(u, lp["mlp"], cfg), None, kv, None
    x, u2 = _residual_norm(x, a, lp["ln2"], cfg)
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
    aux: torch.Tensor            # scalar f32 aux loss (MoE load balance)


def backbone(params, x, positions, cfg: ModelConfig, positions_3d=None,
             want_kv: bool = True) -> ForwardOut:
    check_family(cfg)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    s = None
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        x, s, (k, v), routing = _block(
            x, s, lp, cfg,
            lambda u: L.attention_layer(u, lp["attn"], cfg, positions,
                                        positions_3d),
            _keeps_sum(cfg, i))
        if routing is not None:
            aux = aux + load_balance_loss(*routing, cfg.moe.num_experts)
        if want_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
    return ForwardOut(x, kv, aux)


def forward(params, batch, cfg: ModelConfig, want_kv: bool = False):
    """batch: dict(tokens (b, s), positions (b, npre + s)[, prefix_embeddings
    (b, npre, d), positions_3d (b, npre + s, 3)]).  A model with prefix
    embeddings (the vision frontend's patches, precomputed) reads them
    ahead of the tokens."""
    x = embed(params, batch["tokens"], cfg)
    if cfg.modality is not None and cfg.modality.num_prefix_embeddings:
        x = torch.cat([batch["prefix_embeddings"].to(x.dtype), x], dim=1)
    out = backbone(params, x, batch["positions"], cfg,
                   batch.get("positions_3d"), want_kv=want_kv)
    return unembed(params, out.hidden, cfg), out


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
    s = None
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        x, s, _, _ = _block(
            x, s, lp, cfg, lambda u: (_decode_attn_sublayer(
                u, lp, cfg, state, i, use_peer), None),
            _keeps_sum(cfg, i))
    logits = unembed(params, x, cfg)[:, 0]
    new_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, state._replace(tokens=new_tokens, pos=state.pos + 1)
