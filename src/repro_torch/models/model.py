"""The decoder of the port: dense blocks (serial, or parallel attention and
MLP as in Command-R; the vlm family's are dense blocks with qkv bias and
M-RoPE, behind a prefix of patch embeddings; the audio family's, MusicGen,
dense blocks with a non-gated gelu MLP over the sum of its codebooks'
embeddings plus sinusoidal positions, behind a prefix of conditioning
embeddings, with one head per codebook), MoE blocks where every
layer's FFN is a mixture of experts (``layer_period == 1``) or every other
layer's, after a dense layer (``layer_period == 2``, Llama-4), the hybrid
family (Zamba2: Mamba2 layers with ONE shared attention block after every
``attn_period`` of them) and the ssm family (xLSTM: super-blocks of mLSTM
blocks and one sLSTM block, no attention).

Entry points:
  forward(params, batch, cfg, rules, want_kv) -> (logits, ForwardOut)
  loss_fn(params, batch, cfg, rules)        -> (loss, metrics)
  prefill(params, batch, cfg, rules)        -> (logits_last, ForwardOut)
  serve_step(params, state, cfg, rules)     -> (logits, new_state)  1 token

The audio family's tokens carry a trailing codebook dim: (b, s, ncb) into
``forward``, (b, ncb) in ``DecodeState.tokens``; its logits are (b, s,
ncb, V) and (b, ncb, V).

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
same pool tensors, and new recurrent states.  With ``rules`` (a mesh of
ranks, ``repro_torch.launch.mesh``) each rank holds its shard of the
pools' slots (``bridge.shard_decode``), of the MoE layers' experts and
of the weights that tensor parallelism splits, and the step runs the
JAX package's sharded decode: attention over the rank's own slots for
every head, merged across the ``kv_blocks`` ranks, expert parallelism
over ``act_batch`` and ``experts``, tensor parallelism over ``model``
(``sharding.TensorParallel``: the rank's q heads, and kv heads where
they divide, gathered whole before K1; its heads' block of the output
times its rows of ``wo``, the MLPs' hidden columns and the vocabulary's
rows, each partial product summed over ``model``); the hybrid and ssm
families' recurrent states and layers over the rank's rows
(``act_batch``) and, where the layers' heads divide ``model``, over the
rank's heads (``state_heads``; ``state_specs``).

``forward``, ``loss_fn`` and ``prefill`` with ``rules`` are a rank's
share of the JAX package's sharded pass (every family): the
parameters are the rank's shard (``bridge.shard_train``: d_model dims
over ``data``; experts, heads, kv heads, ``ff`` and the vocabulary over
``model``), the batch the global one, of which the rank computes its
rows (``_rank_rows``).  The embedding, head and final norm are gathered
whole over ``data`` once a pass, each block's weights (a Mamba2 layer's,
an mLSTM or sLSTM block's) inside its ``torch.utils.checkpoint`` region
(so the recompute gathers again and nothing gathered outlives the
block), Zamba2's shared block's once a pass, the MoE layers' inside the
layer (``moe._moe_layer_train``); every gather's gradient is
reduce-scattered back to the shard.  Over ``model`` the pass is tensor
parallel as the JAX package's rules lay it out: the residual holds the
rank's block of d_model (``act_embed``), gathered before each norm;
attention, the MLPs and the shared experts compute the rank's heads or
hidden columns, their row-parallel outputs reduce-scattered back into
the residual's layout; the embedding and the head are
vocabulary-parallel (``loss_fn`` reduces the log-sum-exp and the target
over the ranks); the recurrent layers (Mamba2, mLSTM, sLSTM) compute the
rank's heads where they divide the axis (their leaves and states the
rank's: ``params.leaf_spec``, ``state_specs``), their row-parallel
outputs reduce-scattered likewise, and where they do not, compute whole
on every rank on the gathered stream, their output cut to the
residual's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged_attention as pa
from repro_torch.core.collectives import (TENSOR_PARALLEL, all_gather,
                                          all_reduce, gather_over, sum_over,
                                          tagged)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.moe import load_balance_loss, moe_layer
from repro_torch.models.params import (  # noqa: F401  (re-exported)
    abstract_params, build_schema, check_family, init_params, is_interleaved,
    num_codebooks, param_count, param_specs)
from repro_torch.models.sharding import (batch_rows, gather_fsdp,
                                         kv_block_axes, shard_slices,
                                         strip_stacked, tensor_parallel)


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


def _lookup(table, ids, tp, vocab: int):
    """Rows ``ids`` of an embedding table; with ``tp`` splitting the
    vocabulary, the rank's block of rows answers the ids in its range and
    the others read zero (a partial sum over the ranks)."""
    if tp is None or not tp.splits("vocab", vocab):
        return table[ids]
    local = ids - tp.block(vocab).start
    inr = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(inr[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def embed(params, tokens, cfg: ModelConfig, tp=None):
    """tokens (b, s) -> (b, s, d); the audio family's (b, s, ncb) -> the
    sum of the codebooks' embeddings, added one at a time in codebook
    order, each add rounded in the table's dtype (the jitted JAX ``sum``
    rounds so; one f32 sum rounded once would not match it).  ``tp`` (a
    rank of tensor parallelism): a vocabulary-parallel lookup where the
    vocabulary splits (each rank's rows answer the ids in its range, per
    codebook, and the ranks' partial sums are summed in f32, exact for one
    codebook), in the residual's layout."""
    ncb = num_codebooks(cfg)
    table, tokens = params["embed"], tokens.long()
    V = cfg.vocab_size
    if not ncb:
        x = _lookup(table, tokens, tp, V)
    else:
        x = _lookup(table[0], tokens[..., 0], tp, V)
        for c in range(1, ncb):
            x = x + _lookup(table[c], tokens[..., c], tp, V)
    if tp is None:
        return x
    return tp.out(x, "partial" if tp.splits("vocab", V) else "whole")


def add_positions(x, positions, cfg: ModelConfig, tp=None):
    """The audio family's sinusoidal positions added to the input stream
    (``positions`` (b, s) for ``x`` (b, s, d), or the rank's block of d
    with ``tp`` splitting the residual): the f32 table rounded to x's
    dtype first and then added, as the jitted JAX model adds it; other
    models take their positions in attention and get ``x`` back."""
    if cfg.family != "audio" or cfg.rope_style != "none":
        return x
    table = L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x + (table if tp is None else tp.shard(table))


def unembed(params, x, cfg: ModelConfig, tp=None):
    """The final norm and the head: (b, s, V) logits, (b, s, ncb, V) for
    the audio family.  ``tp``: ``x`` in the residual's layout (gathered
    whole first); where the vocabulary splits, the rank's block of it
    (the tied table's rows, the head's columns, per codebook)."""
    if tp is not None:
        x = tp.whole(x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if num_codebooks(cfg):
        return torch.einsum("bsd,cdv->bscv", x, params["lm_head"])
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def _whole_vocab(logits, cfg: ModelConfig, tp):
    """Logits whole along the vocabulary: a rank's block gathered over
    the ranks where ``tp`` splits it."""
    if tp is None or not tp.splits("vocab", cfg.vocab_size):
        return logits
    with tagged(TENSOR_PARALLEL):
        return gather_over([logits], [logits.dim() - 1], tp.group)[0]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _block(x, s, lp, cfg: ModelConfig, attend, keep_sum: bool = False,
           rules=None, local_rows: bool = False, tp=None):
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
    ``rules``: the MoE FFN's mesh (expert parallelism), or None;
    ``local_rows``: ``x`` is a training rank's own rows
    (``moe_layer``'s).  ``tp``: a rank of tensor parallelism; where it
    splits the residual (training, prefill), ``x`` (and ``s``) are the
    rank's block of d_model, gathered whole before each norm (the
    unrounded f32 sum where the norm reads it).  Returns (x, s, kv, the MoE layer's (probs, ids)
    routing or None)."""
    whole = (lambda t: t) if tp is None else tp.whole
    u = L.rms_norm(whole(x if s is None else s), lp["ln1"],
                   cfg.norm_eps).to(x.dtype)
    a, kv = attend(u)
    if cfg.parallel_block:
        return x + a + L.mlp(u, lp["mlp"], cfg, tp), None, kv, None
    x, u2 = L.residual_norm(x, a, lp["ln2"], cfg.norm_eps, tp)
    if "moe" in lp:
        y, probs, ids = moe_layer(u2, lp["moe"], cfg, rules=rules,
                                  local_rows=local_rows, tp=tp)
        return x + y, None, kv, (probs, ids)
    y = L.mlp(u2, lp["mlp"], cfg, tp)
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
                   attend, remat: bool = False, fsdp=None, tp=None):
    """Zamba2: the Mamba2 stack with ONE shared attention block after every
    ``attn_period`` Mamba2 layers (none after the tail's).  ``states``: the
    stacked ``SSMState`` of every layer, or None (zero states);
    ``attend(j, u, lp)`` -> (a, kv) for the shared block ``lp`` at
    super-block j.  ``remat``: each Mamba2 layer and each shared block
    under ``torch.utils.checkpoint``.  ``fsdp``: the rules of a training
    rank's pass, whose weights split over ``data`` are gathered: each
    Mamba2 layer's inside its recompute region, the shared block's once a
    pass, ahead of its first use (it serves every super-block: 13 at 81
    layers; one gather and one reduce-scatter a step where a gather
    inside each use's region would make 26 and 13, for one block's
    weights and their gradient held whole through the pass).  ``tp``: a
    rank of tensor parallelism: the shared block runs tensor-parallel,
    each Mamba2 layer over the rank's heads where they divide the axis
    (``states`` the rank's), else whole on every rank on the gathered
    stream, its output cut to the residual's layout.  Returns (x, the
    super-blocks' kv, the new stacked states)."""
    per = cfg.hybrid.attn_period
    shared = params["shared_attn"]
    mspec = None
    if fsdp is not None:
        specs = param_specs(cfg, fsdp)
        mspec = strip_stacked(specs["mamba_layers"], 1)
        shared = gather_fsdp(shared, specs["shared_attn"], fsdp)
    if states is None:
        st0 = S.init_ssm_state(cfg, x.shape[0], x.device, params[
            "mamba_layers"]["mamba"]["norm"].shape[-1] // cfg.ssm.head_dim)

    def mamba(x, lp, st):
        if mspec is not None:
            lp = gather_fsdp(lp, mspec, fsdp)
        u = L.rms_norm(x if tp is None else tp.whole(x), lp["ln1"],
                       cfg.norm_eps)
        y, st = S.mamba2_layer(u, lp["mamba"], cfg, st, single_token, tp)
        return x + y, st

    def shared_block(x, j):
        return _block(x, None, shared, cfg, lambda u: attend(j, u, shared),
                      tp=tp)

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
                  remat: bool = False, fsdp=None, tp=None):
    """xLSTM: super-blocks of (slstm_every - 1) mLSTM blocks and one sLSTM
    block.  ``states``: (stacked ``MLSTMState`` over (super-block, block),
    stacked ``SLSTMState`` over super-blocks), or None (zero states).
    ``remat``: each block under ``torch.utils.checkpoint``.  ``fsdp``: the
    rules of a training rank's pass; each block gathers its weights split
    over ``data`` inside its recompute region.  ``tp``: a rank of tensor
    parallelism; each block runs over the rank's heads where they divide
    the axis (``states`` the rank's), else whole on every rank on the
    gathered stream, its output cut to the residual's layout.  Returns
    (x, the new states in that layout)."""
    per = cfg.xlstm.slstm_every
    supers = params["supers"]
    b = x.shape[0]
    mspec = sspec = None
    if fsdp is not None:
        specs = param_specs(cfg, fsdp)["supers"]
        mspec = strip_stacked(specs["mlstm"], 2)
        sspec = strip_stacked(specs["slstm"], 1)

    def mblock(x, lp, st):
        if mspec is not None:
            lp = gather_fsdp(lp, mspec, fsdp)
        return X.mlstm_block(x, lp, cfg, st, single_token, tp)

    def sblock(x, lp, st):
        if sspec is not None:
            lp = gather_fsdp(lp, sspec, fsdp)
        return X.slstm_block(x, lp, cfg, st, single_token, tp)

    mlstm = [_unbind(row) for row in _unbind(supers["mlstm"])]
    slstm = _unbind(supers["slstm"])
    m_new, s_new = [], []
    for j in range(cfg.num_layers // per):
        row = []
        for i in range(per - 1):
            st = X.init_mlstm_state(cfg, b, x.device, mlstm[j][i]["wq"]
                                    .shape[0]) if states is None \
                else X.MLSTMState(*(t[j, i] for t in states[0]))
            x, st = _run(remat, mblock, x, mlstm[j][i], st)
            row.append(st)
        m_new.append(X.MLSTMState(*(torch.stack(t) for t in zip(*row))))
        st = X.init_slstm_state(cfg, b, x.device, slstm[j]["w_rec"]
                                .shape[0]) if states is None \
            else X.SLSTMState(*(t[j] for t in states[1]))
        x, st = _run(remat, sblock, x, slstm[j], st)
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


def state_specs(cfg: ModelConfig, rules, batch: int):
    """The split of each leaf of ``init_states``' layout (``batch`` rows)
    on a rank of ``rules``' mesh, as ``serve_step(rules)`` and the
    sharded prefill hold them: the batch dim (after one stack dim, two for
    the mLSTM states) over ``act_batch`` where the rows divide
    (``batch_rows``); the heads dim, and the conv tails' channels, as the
    layer's leaves split theirs (``param_specs``: Mamba2's conv tail as
    its ``conv_b``, its heads' x channels and every B and C channel;
    mLSTM's its heads' channels).  The JAX package splits the states over
    ``state_heads`` too and keeps the conv tails whole over ``model``.
    None for a family without states."""
    if cfg.family not in ("hybrid", "ssm"):
        return None
    rows = None if batch_rows(rules, batch) is None \
        else rules.axis("act_batch")
    specs = param_specs(cfg, rules)
    if cfg.family == "hybrid":
        m = specs["mamba_layers"]["mamba"]
        heads, conv = m["out_proj"][-2], m["conv_b"][-1]
        return S.SSMState(s=(None, rows, heads, None, None),
                          conv=(None, rows, None, conv))
    m, sl = specs["supers"]["mlstm"], specs["supers"]["slstm"]
    heads = m["wq"][-3]
    return (X.MLSTMState(c=(None, None, rows, heads, None, None),
                         n=(None, None, rows, heads, None),
                         m=(None, None, rows, heads),
                         conv=(None, None, rows, None, m["conv_b"][-1])),
            X.SLSTMState(*((None, rows, sl["w_rec"][-4], None),) * 4))


def shard_states(cfg: ModelConfig, states, rules):
    """``init_states``' layout of the whole batch cut to this rank's block
    (``state_specs``; copies)."""
    batch = (states.s if cfg.family == "hybrid" else states[1].c).shape[1]
    specs = state_specs(cfg, rules, batch)

    def cut(st, sp):
        return type(st)(*(t[shard_slices(rules, s, t.shape)].clone()
                          for t, s in zip(st, sp)))

    if cfg.family == "hybrid":
        return cut(states, specs)
    return cut(states[0], specs[0]), cut(states[1], specs[1])


def backbone(params, x, positions, cfg: ModelConfig, rules=None,
             positions_3d=None, want_kv: bool = True, tp=None) -> ForwardOut:
    """The blocks over the embedded input ``x``.  ``rules``: ``x`` holds a
    training rank's rows and ``params`` its shard (``forward``'s); each
    block gathers its weights inside its recompute region, and each MoE
    layer's load-balance loss counts over the ranks that split the batch
    (``act_batch``; one where every rank runs every row).  ``tp``: the
    rank's tensor parallelism (``x`` its block of d_model); the KV comes
    back whole, each stack's kv heads gathered once where they split."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _wants_grad(params)
    if cfg.family == "hybrid":
        x, kvs, states = _hybrid_layers(
            params, x, cfg, None, False,
            lambda j, u, lp: L.attention_layer(u, lp["attn"], cfg,
                                               positions, tp=tp),
            remat, rules, tp)
        kv = _whole_kv([torch.stack(t) for t in zip(*kvs)], cfg, tp) \
            if want_kv else None
        return ForwardOut(x, kv, states, aux)
    if cfg.family == "ssm":
        x, states = _xlstm_layers(params, x, cfg, None, False, remat, rules,
                                  tp)
        return ForwardOut(x, None, states, aux)

    if rules is not None:
        specs = param_specs(cfg, rules)
        lspecs = ([specs["blocks"][k] for k in ("dense", "moe")]
                  if "blocks" in specs else [specs["layers"]])
        lspecs = [strip_stacked(sp, 1) for sp in lspecs]
        shards = rules.axis_size(rules.axis("act_batch"))

    def block(x, s, lp, i):
        if rules is not None:
            lp = gather_fsdp(lp, lspecs[i % len(lspecs)], rules,
                             skip=("moe",))
        return _block(x, s, lp, cfg,
                      lambda u: L.attention_layer(u, lp["attn"], cfg,
                                                  positions, positions_3d,
                                                  tp),
                      _keeps_sum(cfg, i), rules, local_rows=rules is not None,
                      tp=tp)

    ks, vs = [], []
    s = None
    for i, lp in enumerate(_layers(params)):
        x, s, (k, v), routing = _run(remat, block, x, s, lp, i)
        if routing is not None:
            lb = load_balance_loss(*routing, cfg.moe.num_experts)
            aux = aux + (lb if rules is None else lb / shards)
        if want_kv:
            ks.append(k)
            vs.append(v)
    kv = _whole_kv([torch.stack(ks), torch.stack(vs)], cfg, tp) \
        if want_kv else None
    return ForwardOut(x, kv, None, aux)


def _whole_kv(stacks, cfg: ModelConfig, tp):
    """The stacked (L_kv, b, s, nkv, hd) k and v with every kv head: a
    rank's heads gathered over ``tp``'s axis where they split (one
    collective for both)."""
    if tp is not None and tp.splits("kv_heads", cfg.num_kv_heads):
        with tagged(TENSOR_PARALLEL):
            stacks = gather_over(stacks, [3, 3], tp.group)
    return tuple(stacks)


def _rank_rows(batch, rules):
    """(the rows of the global ``batch`` this rank computes, the rules its
    layers see): its share along ``act_batch`` where the batch's rows
    divide over it (``sharding.batch_rows``); else every row, with
    ``act_batch`` cleared from the rules (the JAX package takes its global
    MoE path there and GSPMD replicates: every rank runs every row)."""
    rows = batch_rows(rules, batch["tokens"].shape[0])
    if rows is not None:
        return {key: v[rows] for key, v in batch.items()}, rules
    return batch, dataclasses.replace(
        rules, rules=dict(rules.rules, act_batch=None))


def _gather_outer(params, cfg: ModelConfig, rules):
    """``params`` with the embedding, the head and the final norm whole
    (gathered over ``data``, differentiable); the layers' shards as they
    are."""
    specs = param_specs(cfg, rules)
    outer = {k: v for k, v in params.items() if k in ("embed", "lm_head",
                                                      "final_norm")}
    return dict(params, **gather_fsdp(outer, {k: specs[k] for k in outer},
                                      rules))


def forward(params, batch, cfg: ModelConfig, rules=None,
            want_kv: bool = False):
    """batch: dict(tokens (b, s) or (b, s, ncb), positions (b, npre + s)[,
    prefix_embeddings (b, npre, d), positions_3d (b, npre + s, 3)]).  A
    model with prefix embeddings (the vision frontend's patches, MusicGen's
    conditioning, precomputed) reads them ahead of the tokens; MusicGen's
    sinusoidal positions are added over the prefix and the tokens alike.
    ``rules``: a training rank's pass (module docstring): ``params`` its
    shard, ``batch`` the global batch; returns the logits of the rank's
    rows (``_rank_rows``), the rank's block of the vocabulary where the
    rules split it (``sharding.TensorParallel``), and a ``ForwardOut``
    whose hidden state is the rank's block of d_model."""
    check_family(cfg)
    tp = None
    if rules is not None:
        batch, rules = _rank_rows(batch, rules)
        params = _gather_outer(params, cfg, rules)
        tp = tensor_parallel(rules, cfg.d_model)
    x = embed(params, batch["tokens"], cfg, tp)
    if cfg.modality is not None and cfg.modality.num_prefix_embeddings:
        pre = batch["prefix_embeddings"].to(x.dtype)
        x = torch.cat([pre if tp is None else tp.shard(pre), x], dim=1)
    x = add_positions(x, batch["positions"], cfg, tp)
    out = backbone(params, x, batch["positions"], cfg, rules,
                   batch.get("positions_3d"), want_kv=want_kv, tp=tp)
    return unembed(params, out.hidden, cfg, tp), out


def _split_vocab_nll_terms(logits, labels, cfg: ModelConfig, tp):
    """(log-sum-exp, the target's logit) over logits (f32) whose last dim
    is the rank's block of the vocabulary, as the JAX package's one-hot
    contraction reduces over a split vocabulary: the rows' maximum over
    the ranks (no gradient), each rank's sum of exponentials and its pick
    of the targets in its range (zero elsewhere), both summed over the
    ranks in one f32 collective whose gradient passes back whole."""
    vl = logits.shape[-1]
    with tagged(TENSOR_PARALLEL):
        mx = all_reduce(logits.detach().amax(dim=-1), "max", tp.group)
    se = torch.exp(logits - mx[..., None]).sum(dim=-1)
    local = labels.clamp(min=0).long() - tp.block(cfg.vocab_size).start
    inr = (local >= 0) & (local < vl)
    pick = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    pick = torch.where(inr, pick, torch.zeros((), device=pick.device))
    with tagged(TENSOR_PARALLEL):
        both = sum_over(torch.stack([se, pick], dim=-1), tp.group)
    return mx + torch.log(both[..., 0]), both[..., 1]


def loss_fn(params, batch, cfg: ModelConfig, rules=None):
    """Mean next-token NLL over the labelled positions (``labels >= 0``;
    the prefix positions of a vlm model cut off) plus the MoE load-balance
    loss times ``lb_loss_weight``, as ``repro.models.model.loss_fn``:
    the log-sum-exp in f32, the target logit gathered (for finite logits
    equal bit for bit to the JAX package's one-hot contraction, without a
    (b, s, V) one-hot).  batch: ``forward``'s and labels (b, s).  Returns
    (loss, {"nll", "aux"}), aux unweighted.  The audio family's labels are
    (b, s, ncb), one per codebook, averaged alike.

    ``rules`` (a training rank on a mesh; ``params`` its shard, ``batch``
    the global batch): the loss returned is the rank's share, whose
    gradient summed over ``act_batch`` and the tensor-parallel axis is the
    global loss's: its rows' NLL summed over the global count of labels,
    plus its load-balance terms (each MoE layer's over the rank's rows,
    over the number of ranks that split the batch); where every rank runs
    every row, the whole loss over that number.  Over a split vocabulary
    each rank's NLL reads its block of the logits
    (``_split_vocab_nll_terms``); a term that every tensor-parallel rank
    computes alike (the NLL of whole logits, the load-balance loss) counts
    over their number, since each whole leaf's gradient is summed over
    them.  The metrics hold the global "loss", "nll" and "aux": the
    ranks' shares summed over ``act_batch``."""
    logits, out = forward(params, batch, cfg, rules)
    labels = batch["labels"]
    share, group, tp = 1.0, None, None
    if rules is not None:
        rows, seen = _rank_rows(batch, rules)
        labels = rows["labels"]
        group = rules.mesh.group(rules.axis("act_batch"))
        if seen is not rules:       # every rank ran every row
            share = 1.0 / rules.axis_size(rules.axis("act_batch"))
        tp = tensor_parallel(rules)
    npre = cfg.modality.num_prefix_embeddings if cfg.modality else 0
    if npre:
        logits = logits[:, npre:]
    if labels.dim() != logits.dim() - 1:
        raise ValueError("labels must be one rank below logits")
    logits = logits.float()
    split = tp is not None and tp.splits("vocab", cfg.vocab_size)
    if split:
        lse, tgt = _split_vocab_nll_terms(logits, labels, cfg, tp)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum()
    if group is not None and share == 1.0:
        count = all_reduce(count, "sum", group)     # the global count
    nll = torch.sum((lse - tgt) * mask) / torch.clamp(count, min=1.0)
    aux = out.aux
    if share != 1.0:
        nll, aux = nll * share, aux * share
    weight = cfg.moe.lb_loss_weight if cfg.moe else 0.0
    loss = nll + aux * weight
    if group is None:
        return loss, {"nll": nll, "aux": aux}
    total = all_reduce(torch.stack([loss, nll, aux]).detach(), "sum", group)
    if tp is not None:
        loss = (nll if split else nll / tp.size) + aux * (weight / tp.size)
    return loss, {"loss": total[0], "nll": total[1], "aux": total[2]}


def prefill(params, batch, cfg: ModelConfig, rules=None):
    """Full-sequence pass returning last-token logits + cache material.
    ``rules``: a rank's pass over a mesh, as the JAX package's sharded
    ``prefill``, under ``torch.no_grad()``: ``params`` the rank's shard
    (``bridge.shard_train``), ``batch`` the global batch; it returns the
    logits (whole along the vocabulary), the KV (every kv head) and the
    final recurrent states of the rank's rows (``_rank_rows``), its blocks
    gathering their weights over ``data``, running tensor-parallel over
    ``model`` and the MoE layers taking the expert-parallel path."""
    if rules is None:
        logits, out = forward(params, batch, cfg, want_kv=True)
        return logits[:, -1], out
    with torch.no_grad():
        logits, out = forward(params, batch, cfg, rules, want_kv=True)
        logits = _whole_vocab(logits[:, -1], cfg, tensor_parallel(rules))
    return logits, out


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
    tokens: torch.Tensor      # (b,) or (b, ncb) last emitted token(s)
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


def _kv_shard(rules):
    """(the process group of the ranks the pools' slots are sharded over,
    this rank's shard index), or (None, 0) without rules."""
    if rules is None:
        return None, 0
    axes = kv_block_axes(rules)
    return rules.mesh.group(axes), rules.mesh.axis_index(axes)


def _decode_attn_sublayer(u, lp, cfg, state: DecodeState, layer: int,
                          use_peer: bool, rules=None, tp=None):
    """u: (b, 1, d), the normed residual. Appends this step's k/v to layer
    ``layer`` of the pools in place and returns the attention output (b,
    1, d).  With ``rules`` the pools are this rank's shard of the slots
    (shard ``idx`` holds global slots ``idx * n_slots`` on): a row's k and
    v land here only where its append slot does, K1 runs over the rank's
    slots, and the ranks' partials merge in ``finalize``.  ``tp`` (tensor
    parallelism; the pools keep every head on every rank, as the JAX
    package's decode does): q, and k and v where their heads split, are
    the rank's heads and are gathered whole first; after the merge each
    rank multiplies its heads' block of the output by its block of ``wo``
    and the products are summed over the axis."""
    p3 = None if state.positions_3d is None else state.positions_3d[:, None]
    p = lp["attn"]
    q, k, v = L.rotary_qkv(u, p, cfg, state.pos[:, None], p3)
    heads = tp is not None and tp.splits("heads", cfg.num_heads)
    if heads:
        split = [q, k, v] if tp.splits("kv_heads", cfg.num_kv_heads) else [q]
        with tagged(TENSOR_PARALLEL):
            got = gather_over(split, [2] * len(split), tp.group)
        q, k, v = got if len(got) == 3 else (got[0], k, v)
    kvp = state.kv
    pk, pv = kvp.pool_k[layer], kvp.pool_v[layer]
    group, idx = _kv_shard(rules)
    a_slot = kvp.append_slot if idx == 0 else \
        kvp.append_slot - idx * pk.shape[0]
    pa.append_kv(pk, pv, k[:, 0], v[:, 0], a_slot, kvp.append_off)
    pools = [(pk, pv, kvp.slot_req, kvp.slot_base)]
    if use_peer:
        pp = state.peer
        pools.append((pp.pool_k[layer], pp.pool_v[layer], pp.slot_req,
                      pp.slot_base))
    o = pa.paged_decode_attention(q[:, 0], pools, state.pos, cfg, group)
    if not heads:
        return torch.einsum("bnh,nhd->bd", o.to(u.dtype), p["wo"])[:, None]
    o = o[:, tp.block(cfg.num_heads)].to(u.dtype)
    y = L.row_parallel(o, p["wo"], 2)[:, None]
    return tp.out(y, "partial", dtype=u.dtype)


def _state_rows(cfg: ModelConfig, state: DecodeState, rules):
    """(this rank's rows of the batch, the process group and order of the
    ranks that split it) where ``rules`` split a recurrent family's
    decode batch over ``act_batch`` (more than one rank, the rows
    dividing over them); else None: every rank runs every row."""
    if rules is None or cfg.family not in ("hybrid", "ssm"):
        return None
    rows = batch_rows(rules, state.tokens.shape[0])
    ax = rules.axis("act_batch")
    if rows is None or rules.axis_size(ax) == 1:
        return None
    return rows, rules.mesh.group(ax), rules.mesh.group_order(ax)


def serve_step(params, state: DecodeState, cfg: ModelConfig,
               harvest_inplace: bool = False, rules=None):
    """Decode ONE token for every active request. Returns (logits, state):
    logits (b, V), or (b, ncb, V) for the audio family, and the argmax
    tokens in ``state.tokens``.  ``harvest_inplace`` with ``state.peer``
    set: the harvested peer pool joins each layer's softmax where it lies
    (K1 over each pool, the partials merged by log-sum-exp); the step's k
    and v go to the local pool alone.  ``rules``: this rank's place on a
    mesh of ranks (module docstring); None runs on one device.

    The hybrid and ssm families on a mesh whose ``act_batch`` splits the
    rows (``_state_rows``): ``state.states`` holds the rank's rows alone
    (``bridge.shard_decode``) and the recurrent layers run over them;
    tokens, positions and the pools' bookkeeping stay global.  Where the
    layers' heads divide ``model``, the states are the rank's heads too
    (``state_specs``) and the layers run tensor-parallel.  Zamba2's
    shared attention block gathers its normed input over ``act_batch``,
    serves every row against the rank's slots (K1, merged over
    ``kv_blocks``) and keeps its rows of the output.  The logits returned
    are the rank's rows'; ``tokens`` comes back gathered whole, so the
    next step's input is global again."""
    check_family(cfg)
    tp = tensor_parallel(rules)
    split = _state_rows(cfg, state, rules)
    tokens = state.tokens if split is None else state.tokens[split[0]]
    pos = state.pos if split is None else state.pos[split[0]]
    x = add_positions(embed(params, tokens[:, None], cfg, tp), pos[:, None],
                      cfg)
    use_peer = harvest_inplace and state.peer is not None
    states = state.states

    def shared_attend(j, u, lp):
        if split is not None:
            u = all_gather(u, split[1], split[2])
        a = _decode_attn_sublayer(u, lp, cfg, state, j, use_peer, rules, tp)
        return (a if split is None else a[split[0]]), None

    if cfg.family == "hybrid":
        x, _, states = _hybrid_layers(params, x, cfg, state.states, True,
                                      shared_attend, tp=tp)
    elif cfg.family == "ssm":
        x, states = _xlstm_layers(params, x, cfg, state.states, True, tp=tp)
    else:
        s = None
        for i, lp in enumerate(_layers(params)):
            x, s, _, _ = _block(
                x, s, lp, cfg, lambda u: (_decode_attn_sublayer(
                    u, lp, cfg, state, i, use_peer, rules, tp), None),
                _keeps_sum(cfg, i), rules, tp=tp)
    logits = _whole_vocab(unembed(params, x, cfg, tp)[:, 0], cfg, tp)
    new_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    if split is not None:
        new_tokens = all_gather(new_tokens, split[1], split[2])
    return logits, state._replace(tokens=new_tokens, pos=state.pos + 1,
                                  states=states)
