"""Paged decode attention over tiered Harvest KV pools.

The KV cache is a pool of fixed-size blocks with an *inverted* block table:
per pool slot, which request owns it and which position range it covers.
Each pool yields flash-decode partials (m, l, acc) over its slots, and
partials merge associatively via log-sum-exp across pools/tiers, which is
what lets the peer tier join the attention in place.

Shapes (one pool):
  q:        (b, nq, hd)            current-token queries
  pool_k/v: (n_slots, bs, nkv, hd) block pool
  slot_req: (n_slots,) int32       owning request (-1 = free slot)
  slot_base:(n_slots,) int32       position of the block's first token
  q_pos:    (b,) int32             current decode position per request

``pool_partials`` runs kernel K1 on the card (its plain version on the CPU);
the merge, the normalisation and the KV append are plain PyTorch.  With
the pool's slot dimension sharded over ranks, each rank merges its own
pools' partials and ``finalize`` merges the ranks' over a process group,
as the JAX package's ``pmax``/``psum`` do inside ``shard_map``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import all_reduce
from repro_torch.kernels.paged_attention.ops import (NEG_INF, Partials,
                                                     paged_decode_partials)

__all__ = ["NEG_INF", "Partials", "pool_partials", "merge_partials",
           "finalize", "append_kv", "paged_decode_attention"]


def pool_partials(q, pool_k, pool_v, slot_req, slot_base, q_pos,
                  cfg: ModelConfig) -> Partials:
    """Flash-decode partials of one pool (tier)."""
    hd = q.shape[-1]
    return paged_decode_partials(
        q.float().contiguous(), pool_k, pool_v, slot_req, slot_base, q_pos,
        scale=hd ** -0.5, sliding_window=cfg.sliding_window,
        attention_chunk=cfg.attention_chunk,
        logit_softcap=cfg.logit_softcap)


def merge_partials(parts: Sequence[Partials]) -> Partials:
    """Associative LSE merge across tiers/pools."""
    out = parts[0]
    for p in parts[1:]:
        m = torch.maximum(out.m, p.m)
        c0 = torch.exp(out.m - m)
        c1 = torch.exp(p.m - m)
        out = Partials(m=m,
                       l=out.l * c0 + p.l * c1,
                       acc=out.acc * c0[..., None] + p.acc * c1[..., None])
    return out


def finalize(parts: Partials, group=None) -> torch.Tensor:
    """Cross-rank merge over ``group`` (a process group; the max of m,
    then the sums of ``l * corr`` and ``acc * corr``) and normalisation.
    Returns (b, nq, hd) f32.  A rank that holds no block of a row has m
    -1e30 and l 0 there, so its corr is 0 and it adds nothing; with no
    group it is a plain normalisation."""
    m, l, acc = parts
    if group is not None:
        m_g = all_reduce(m.clone(), "max", group)
        corr = torch.exp(m - m_g)
        # l and acc reduced in one buffer
        both = torch.cat([(l * corr).reshape(-1),
                          (acc * corr[..., None]).reshape(-1)])
        all_reduce(both, "sum", group)
        l, acc = both[:l.numel()].view(l.shape), \
            both[l.numel():].view(acc.shape)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    b, nkv, gq, hd = out.shape
    return out.reshape(b, nkv * gq, hd)


def append_kv(pool_k, pool_v, k_new, v_new, local_slot, offset):
    """Write this step's (k, v) into the pool IN PLACE (the JAX code
    rebuilds the pool with ``.at[].set``).

    k_new/v_new: (b, nkv, hd);  local_slot/offset: (b,) int.  Rows whose
    slot is ``n_slots`` (their block lives elsewhere) are dropped, as the
    JAX scatter's drop mode does.  Returns the pools.

    On ``meta`` tensors (a dry run) the rows kept depend on slot values
    it cannot read (a boolean mask needs ``nonzero``, which has no meta
    kernel): every row is written, the most a step writes.
    """
    if pool_k.device.type == "meta":
        slot, off = local_slot.long(), offset.long()
        pool_k[slot, off] = k_new.to(pool_k.dtype)
        pool_v[slot, off] = v_new.to(pool_v.dtype)
        return pool_k, pool_v
    keep = (local_slot >= 0) & (local_slot < pool_k.shape[0])
    slot, off = local_slot[keep].long(), offset[keep].long()
    pool_k[slot, off] = k_new[keep].to(pool_k.dtype)
    pool_v[slot, off] = v_new[keep].to(pool_v.dtype)
    return pool_k, pool_v


def paged_decode_attention(q, pools, q_pos, cfg: ModelConfig,
                           group=None) -> torch.Tensor:
    """Attention of one decode token against the union of KV pools.

    ``pools`` is a sequence of (pool_k, pool_v, slot_req, slot_base) tuples:
    [local] (fetch mode: peer blocks were copied in before the step) or
    [local, peer] (in-place mode: the harvested tier joins the softmax).
    ``group``: the ranks over which the pools' slots are sharded (each
    passes its own shards), or None.
    """
    parts = [pool_partials(q, pk, pv, sr, sb, q_pos, cfg)
             for (pk, pv, sr, sb) in pools]
    return finalize(merge_partials(parts), group)
