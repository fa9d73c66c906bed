"""Abstract inputs for every (architecture x input shape) pair, and one
rank's step over them: the port's counterpart of the JAX package's
``repro/launch/specs.py``.

``build_step(cfg, shape, rules)`` returns (fn, args): the port's own
entry point and one rank's arguments as tensors on the ``meta`` device,
which hold shapes and dtypes and no storage, so nothing is allocated
(the JAX package's ``ShapeDtypeStruct`` pattern).  The JAX package hands
GSPMD the global arguments and their shardings; a rank of the port holds
its own share, which ``args`` is:

  train    -> ``train_step(..., rules)``: the rank's parameter shards
              (``params.leaf_spec``: d_model over ``data``; experts,
              heads, kv heads, ``ff``, the vocabulary and the recurrent
              layers' heads over ``model``), their AdamW moments, the
              global batch
  prefill  -> ``prefill(..., rules)``: the shards, the global batch
  decode   -> ``serve_step(..., rules)``: the rank's block of every
              weight that tensor parallelism splits over ``model`` and of
              the experts (``bridge.shard_decode``: E / |experts| a rank
              where the batch takes the expert-parallel path), the rest
              whole, the rank's slots of the KV pools, the hybrid and ssm
              families' recurrent states of the rank's rows (the batch
              over ``act_batch``, where it divides) and heads (over
              ``model``, where the layers' heads divide it;
              ``model.state_specs``), the rest of the decode state whole

Global shapes and dtypes are the JAX package's, pool slot counts
included (``shards * ceil(n / shards)``).  The JAX package's dry run
replicates the decode batch (``act_batch`` cleared) for the families
whose per-request state is paged KV, and keeps it split for the hybrid
and ssm families, whose recurrent states grow with the batch.  The
port's decode step keeps tokens, positions and the pools' bookkeeping
whole on every rank for every family, and for the recurrent families
splits the states and the layers that read them over ``act_batch`` and
their heads over ``model`` (``state_heads``, as the JAX package does; the
conv tails hold the rank's channels where JAX keeps them whole over
``model``); its MoE layers keep
``act_batch`` for their dispatch, the expert parallelism
``serve_step(rules)`` runs.  The JAX package's uncarried-pool baseline
(an environment switch there) has no counterpart: the port's pools are
written in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import bridge
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import total_shards
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardingRules
from repro_torch.train.optim import adamw_init, train_step

KV_BLOCK_SIZE = 256
DECODE_HEADROOM_BLOCKS = 1

_I32 = torch.int32


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Batch specs (train / prefill)
# ---------------------------------------------------------------------------


def abstract_batch(cfg: ModelConfig, shape: InputShape, with_labels: bool):
    """The global batch of ``shape`` on ``meta``: tokens (b, s) ((b, s,
    ncb) for the audio family), positions (b, npre + s), prefix
    embeddings (bf16), M-RoPE positions and labels where the model and
    the kind take them."""
    b, s = shape.global_batch, shape.seq_len
    npre = cfg.modality.num_prefix_embeddings if cfg.modality else 0
    s_tok = s - npre
    ncb = cfg.modality.num_codebooks if cfg.modality else 1
    tok_shape = (b, s_tok, ncb) if (cfg.family == "audio" and ncb > 1) \
        else (b, s_tok)
    batch = {"tokens": _meta(tok_shape, _I32),
             "positions": _meta((b, s), _I32)}
    if npre:
        batch["prefix_embeddings"] = _meta((b, npre, cfg.d_model),
                                           torch.bfloat16)
    if cfg.rope_style == "mrope":
        batch["positions_3d"] = _meta((b, s, 3), _I32)
    if with_labels:
        batch["labels"] = _meta(tok_shape, _I32)
    return batch


# ---------------------------------------------------------------------------
# Decode state specs
# ---------------------------------------------------------------------------


def blocks_per_request(cfg: ModelConfig, seq_len: int,
                       block_size: int = KV_BLOCK_SIZE) -> int:
    """KV working set in blocks: SWA/chunked attention bound it."""
    span = seq_len
    if cfg.sliding_window is not None:
        span = min(span, cfg.sliding_window)
    if cfg.attention_chunk is not None:
        span = min(span, cfg.attention_chunk)
    return math.ceil(span / block_size) + DECODE_HEADROOM_BLOCKS


def abstract_decode_state(cfg: ModelConfig, shape: InputShape,
                          rules: Optional[ShardingRules],
                          block_size: int = KV_BLOCK_SIZE,
                          peer_fraction: float = 0.0) -> M.DecodeState:
    """The global ``DecodeState`` of ``shape`` on ``meta``: bf16 pools of
    ``shards * ceil(n / shards)`` slots (a peer pool of ``peer_fraction``
    of them where it is above 0), the recurrent states of every row and
    head stacked as the model returns them (``build_step`` keeps a rank's
    rows and heads, ``bridge.shard_decode``), tokens, positions and
    M-RoPE ids."""
    b, seq = shape.global_batch, shape.seq_len
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L_kv = M.num_kv_layers(cfg)
    shards = total_shards(rules) if rules is not None else 1

    def pools(n_needed):
        n_slots = shards * math.ceil(n_needed / shards)
        pool = (L_kv, n_slots, block_size, nkv, hd)
        return M.KVPools(pool_k=_meta(pool, torch.bfloat16),
                         pool_v=_meta(pool, torch.bfloat16),
                         slot_req=_meta((n_slots,), _I32),
                         slot_base=_meta((n_slots,), _I32),
                         append_slot=_meta((b,), _I32),
                         append_off=_meta((b,), _I32))

    kv = peer = None
    if L_kv:
        n_needed = b * blocks_per_request(cfg, seq, block_size)
        kv = pools(n_needed)
        if peer_fraction > 0:
            peer = pools(max(int(n_needed * peer_fraction), shards))
    ncb = cfg.modality.num_codebooks if cfg.modality else 1
    tokens = _meta((b, ncb), _I32) if (cfg.family == "audio" and ncb > 1) \
        else _meta((b,), _I32)
    p3 = _meta((b, 3), _I32) if cfg.rope_style == "mrope" else None
    return M.DecodeState(tokens=tokens, pos=_meta((b,), _I32), kv=kv,
                         peer=peer, states=M.init_states(cfg, b, "meta"),
                         positions_3d=p3)


# ---------------------------------------------------------------------------
# One rank's step
# ---------------------------------------------------------------------------


def build_step(cfg: ModelConfig, shape: InputShape,
               rules: Optional[ShardingRules],
               harvest_inplace: bool = False, peer_fraction: float = 0.0):
    """(fn, args): ``fn(*args)`` is the rank's step of ``shape``'s kind
    over its ``meta`` arguments (module docstring); ``rules`` None runs
    on one device."""
    if shape.kind in ("train", "prefill"):
        params = M.abstract_params(cfg, rules)
        if shape.kind == "train":
            def train(params, opt, batch):
                return train_step(params, opt, batch, cfg, rules)

            return train, (params, adamw_init(params),
                           abstract_batch(cfg, shape, with_labels=True))

        def prefill(params, batch):
            logits, out = M.prefill(params, batch, cfg, rules)
            return logits, out.kv, out.states

        return prefill, (params, abstract_batch(cfg, shape,
                                                with_labels=False))

    params = M.abstract_params(cfg)
    state = abstract_decode_state(cfg, shape, rules,
                                  peer_fraction=peer_fraction)
    if rules is not None:
        params, state = bridge.shard_decode(params, state, cfg, rules)

    def decode(params, state):
        return M.serve_step(params, state, cfg,
                            harvest_inplace=harvest_inplace, rules=rules)

    return decode, (params, state)


__all__ = ["KV_BLOCK_SIZE", "abstract_batch", "blocks_per_request",
           "abstract_decode_state", "build_step"]
