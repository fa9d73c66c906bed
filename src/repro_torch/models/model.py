"""The dense decoder of the port.

Entry points:
  forward(params, batch, cfg, want_kv)      -> (logits, ForwardOut)
  prefill(params, batch, cfg)               -> (logits_last, ForwardOut)
  serve_step(params, state, cfg)            -> (logits, new_state)  1 token

Parameters are the nested dict of ``repro_torch.models.params`` (leaves
stacked over layers); the JAX package's layer ``scan`` is a Python loop.
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
from repro_torch.models.params import (  # noqa: F401  (re-exported)
    build_schema, init_params, param_count)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.parallel_block:
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense sequential-block family "
            f"so far (family {cfg.family!r})")


def _layer(params, i: int):
    """Layer ``i``'s slice of the stacked layer parameters."""
    def pick(node):
        return {k: pick(v) for k, v in node.items()} \
            if isinstance(node, dict) else node[i]
    return pick(params["layers"])


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


def dense_block(x, lp, cfg: ModelConfig, positions):
    """Pre-LN block. Returns (x, kv)."""
    u = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, kv = L.attention_layer(u, lp["attn"], cfg, positions)
    x, u2 = _residual_norm(x, a, lp["ln2"], cfg)
    x = x + L.mlp(u2, lp["mlp"], cfg)
    return x, kv


class ForwardOut(NamedTuple):
    hidden: torch.Tensor         # (b, s, d)
    kv: Optional[Any]            # stacked (L_kv, b, s, nkv, hd) k and v


def backbone(params, x, positions, cfg: ModelConfig,
             want_kv: bool = True) -> ForwardOut:
    _check_family(cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = dense_block(x, _layer(params, i), cfg, positions)
        if want_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
    return ForwardOut(x, kv)


def forward(params, batch, cfg: ModelConfig, want_kv: bool = False):
    """batch: dict(tokens (b, s), positions (b, s))."""
    x = embed(params, batch["tokens"], cfg)
    out = backbone(params, x, batch["positions"], cfg, want_kv=want_kv)
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


def num_kv_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.attn_period
    return cfg.num_layers


def _decode_attn_sublayer(x, lp, cfg, state: DecodeState, layer: int,
                          use_peer: bool):
    """x: (b, 1, d). Appends this step's k/v to layer ``layer`` of the
    pools in place and returns the attention output (b, 1, d)."""
    u = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(u, lp["attn"], cfg)
    positions = state.pos[:, None]
    q = L.position_embedding(q, positions, cfg)
    k = L.position_embedding(k, positions, cfg)
    kvp = state.kv
    pk, pv = kvp.pool_k[layer], kvp.pool_v[layer]
    pa.append_kv(pk, pv, k[:, 0], v[:, 0], kvp.append_slot, kvp.append_off)
    pools = [(pk, pv, kvp.slot_req, kvp.slot_base)]
    if use_peer:
        pp = state.peer
        pools.append((pp.pool_k[layer], pp.pool_v[layer], pp.slot_req,
                      pp.slot_base))
    o = pa.paged_decode_attention(q[:, 0], pools, state.pos, cfg)
    y = torch.einsum("bnh,nhd->bd", o.to(x.dtype), lp["attn"]["wo"])
    return y[:, None]


def serve_step(params, state: DecodeState, cfg: ModelConfig,
               harvest_inplace: bool = False):
    """Decode ONE token for every active request. Returns (logits, state)."""
    _check_family(cfg)
    x = embed(params, state.tokens[:, None], cfg)
    use_peer = harvest_inplace and state.peer is not None
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        a = _decode_attn_sublayer(x, lp, cfg, state, i, use_peer)
        x, u2 = _residual_norm(x, a, lp["ln2"], cfg)
        x = x + L.mlp(u2, lp["mlp"], cfg)
    logits = unembed(params, x, cfg)[:, 0]
    new_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, state._replace(tokens=new_tokens, pos=state.pos + 1)
