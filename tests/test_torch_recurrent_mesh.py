"""The hybrid (Zamba2) and ssm (xLSTM) families on a mesh of ranks, held to
the JAX package's sharded functions on the same (data, model) mesh.

The port's side: ``forward`` / ``loss_fn`` / ``train_step(..., rules)``
over each rank's rows (``_rank_rows``), each Mamba2 layer and xLSTM block
gathering its weights split over ``data`` inside its recompute region and
Zamba2's shared block once a pass (``gather_fsdp``); ``prefill(rules)``
returning the rank's rows of the logits, the KV and the final states;
``serve_step(rules)`` running the recurrent layers over the rank's rows of
the states (``bridge.shard_decode`` cuts them), Zamba2's shared attention
gathering its normed input over ``data`` to serve every row against the
rank's slots, the tokens gathered whole.  Under the default rules the
Mamba2, mLSTM and sLSTM layers run over the rank's heads too (their heads
divide the ``model`` axis here), and the states the rank holds are its
rows' and its heads' (``_state_cut``).

The JAX reference runs in one subprocess, this file run as a script
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before jax
loads, meshes of Auto axes, ``make_rules(mesh)``); the port in one launch
of 4 gloo ranks on the CPU.  The fixture starts both at once; they read
the same inputs (``inputs.npz``: the JAX package's ``init_params``
weights, Mamba2's per-head constants drawn at random as
tests/test_torch_ssm.py draws them, numpy batches, and for decode the
states of an unsharded JAX prefill of the rows and random pools).

Models: reduced zamba2-7b at 5 layers (``attn_period`` 2: two
super-blocks and a tail layer) and reduced xlstm-1.3b at 4 (two
super-blocks), 40 tokens a row (past the SSD chunk of 32).  Cases:
training (``TRAIN``) in f32 and bf16 on (data 2, model 2), in f32 on (4,
1) and with 3 rows, which do not divide over ``data``; prefill and four
decode steps (``PREFILL``, ``DECODE``) in f32 and bf16 on (2, 2).  The
training cases run data parallelism and FSDP over the mesh with tensor
parallelism off (``_without_tensor_parallelism``), and those of
``TP_TRAIN`` again under the default rules, held to the same JAX runs:
Zamba2's shared block and both families' embedding and head
tensor-parallel over ``model``, and the recurrent layers split by
heads.  Prefill and decode run the default rules.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_sharded_train import (TP_UNSHARDED_REL, _bits, _flatten,
                                      _hold_tree, _sharded_grads, _unflatten,
                                      _unsharded_grads, _whole_leaves,
                                      _without_tensor_parallelism)

AXES = ("data", "model")
ZAMBA, XLSTM = "zamba2-7b", "xlstm-1.3b"
#: Zamba2: two super-blocks of two Mamba2 layers and the shared block,
#: then a tail layer; xLSTM: two super-blocks of an mLSTM and an sLSTM
LAYERS = {ZAMBA: 5, XLSTM: 4}
SEQ = 40
LR = 1e-3
#: case -> (arch, dtype, mesh shape, batch rows)
TRAIN = {
    "zamba2-f32": (ZAMBA, "float32", (2, 2), 4),
    "zamba2-bf16": (ZAMBA, "bfloat16", (2, 2), 4),
    "zamba2-4x1-f32": (ZAMBA, "float32", (4, 1), 4),
    "xlstm-f32": (XLSTM, "float32", (2, 2), 4),
    "xlstm-bf16": (XLSTM, "bfloat16", (2, 2), 4),
    # 3 rows over 2 data ranks: every rank runs every row
    "xlstm-odd-f32": (XLSTM, "float32", (2, 2), 3),
}
#: the training cases run a second time with tensor parallelism over
#: ``model`` (the default rules): those with more than one ``model`` rank
TP_TRAIN = [c for c, (_, _, shape, _) in TRAIN.items() if shape[1] > 1]
#: case -> (arch, dtype); 4 rows of SEQ tokens on (2, 2)
PREFILL = {"zamba2-f32": (ZAMBA, "float32"), "zamba2-bf16": (ZAMBA, "bfloat16"),
           "xlstm-f32": (XLSTM, "float32"), "xlstm-bf16": (XLSTM, "bfloat16")}
#: decode: the same cases; four steps of 4 rows from the states of an
#: unsharded prefill of SEQ tokens, zamba2's pools dealt at these positions
DECODE = PREFILL
MESH = (2, 2)
B, BS, STEPS = 4, 8, 4
POS = (41, 24, 33, 17)
#: f32: each tensor within this much of its largest entry (gradients,
#: parameters, moments, logits, KV and states), losses and the norm to
#: this relative tolerance (tests/test_torch_sharded_train.py's F32_REL)
F32_REL = 1e-5
#: bf16 gradients per leaf against the port's own unsharded gradients,
#: two bf16 steps of its largest entry (tests/test_torch_train_grads.py's
#: BF16_GRAD_REL; measured: 1.02% zamba2's shared ``wv``, 0.66% xlstm's
#: sLSTM ``ln``)
BF16_GRAD_REL = 2.0 ** -6
#: ... and against JAX's sharded gradients: four bf16 steps.  The port's
#: unsharded bf16 gradients of these two models already stand up to 2.2%
#: of a leaf's largest entry from JAX's unsharded ones (Mamba2's
#: ``conv_w``, the xLSTM biases summed over every token: XLA rounds its
#: fused bf16 intermediates otherwise than eager PyTorch); measured
#: sharded: 1.83% (zamba2 ``conv_b``), 3.34% (xlstm mLSTM ``b_gates``)
BF16_JAX_GRAD_REL = 2.0 ** -4
#: bf16 losses: f32 sums over bf16 logits in another order
BF16_LOSS_REL = 1e-3
#: bf16 gradient norm against JAX's: the norm of gradients that stand
#: apart as ``BF16_JAX_GRAD_REL`` says (measured: 0.14% zamba2, 0.12%
#: xlstm)
BF16_GNORM_REL = 2.0 ** -8
#: bf16 moments against JAX's after each of two AdamW steps: ``mu`` a
#: sum of gradients, within their bound; ``nu`` of their squares, twice
#: it (measured: 3.44% and 5.09% at most)
BF16_MOMENT_REL = {"mu": BF16_JAX_GRAD_REL, "nu": 2 * BF16_JAX_GRAD_REL}
#: f32 after the second step: AdamW moves a parameter by about +-lr
#: whatever |g| while |g| >> eps, so an entry whose first gradient sits
#: within the two frameworks' f32 noise of 0 moves either way, and the
#: second step's gradients follow the moved parameters: its moments within
#: this much of each leaf's largest entry (measured: 1.7e-4, zamba2's
#: shared ``mlp/wo`` on (4, 1)), and all but this share of the parameters
#: within 2e-6 (measured: 1.04e-4, xlstm with 3 rows), every one within
#: 2 lr a step
MOMENT2_REL = 1e-3
PARAMS_OFF_SHARE = 1e-3
#: bf16 prefill and decode against JAX: the logits, the KV and each state
#: leaf within four bf16 steps of its tensor's largest entry (measured:
#: 1.61% xlstm's prefilled mLSTM matrix memory, 1.31% zamba2's k; the
#: decode steps' states 0.91% at most)
BF16_REL = 2.0 ** -5
#: the sharded port against the unsharded port in f32: nll, the norm and
#: every gradient, the decode steps' logits, states and pools (measured
#: 6.1e-7 at most)
UNSHARDED_REL = 1e-6
#: tensor parallelism's runs (``TP_TRAIN``), where its roundings add to
#: those above: its vocabulary-parallel log-sum-exp sums in another order,
#: and in bf16 a few entries of the logits' gradient round the other way,
#: which the biases summed over every token (the mLSTM's ``b_gates``)
#: carry.  f32: the first step's ``nu``, a square of the gradient, within
#: twice ``F32_REL`` (measured 1.17e-5, xlstm's ``b_gates``; its ``mu``
#: 5.8e-6).  bf16 moments against JAX's within twice the gradients' bound
#: (measured: ``mu`` 6.85% and ``nu`` 6.47% after the second step, xlstm's
#: ``b_gates``; without tensor parallelism 2.98% and 5.09%).  bf16
#: gradients against the port's unsharded ones within four bf16 steps of
#: a leaf's largest entry (measured 1.59% xlstm's mLSTM ``out_norm``,
#: 1.48% zamba2's ``embed``)
TP_F32_NU0_REL = 2 * F32_REL
TP_BF16_MOMENT_REL = {"mu": 2 * BF16_JAX_GRAD_REL, "nu": 2 * BF16_JAX_GRAD_REL}
TP_BF16_GRAD_REL = 2.0 ** -5
#: bf16 decode logit vectors (step * B + row) where JAX's top-1/top-2 gap
#: is under twice the vector's largest difference (0.0156 zamba2, 0.0098
#: xlstm) and the two deciding logits differ by a rounding step: the
#: tokens are equal there all the same (asserted); the sharded and the
#: unsharded port agree bit for bit
KNOWN_NEAR_TIES = {"zamba2-bf16": (6, 8, 11), "xlstm-bf16": (4,)}
TIMEOUT_S = 600


def _configs(arch):
    """(JAX config, port config), reduced, at ``LAYERS[arch]`` layers."""
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    n = LAYERS[arch]
    return (dataclasses.replace(get_config(arch).reduced(), num_layers=n),
            dataclasses.replace(t_get_config(arch).reduced(), num_layers=n))


def _rows(rank, shape=MESH, b=B):
    """The rows a rank of ``shape`` computes where ``b`` divides over
    ``data``, else every row."""
    n = shape[0]
    if b % n:
        return slice(None)
    i = rank // shape[1]
    return slice(i * b // n, (i + 1) * b // n)


def _state_cut(arch, j, a, rank, shape=MESH):
    """State leaf ``j`` (in the JAX package's leaf order) of every row and
    head, ``a``, cut to what a rank of ``shape`` holds: its rows
    (``_rows``) and its ``model`` index's block of the heads; a conv
    tail its channels (zamba2's: its heads' x channels and every B and C
    channel; the mLSTM's: its heads' channels), reckoned from
    ``ssm_dims`` and ``xlstm_dims``."""
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.models.xlstm import xlstm_dims
    _, cfg = _configs(arch)
    lead = 2 if arch == XLSTM and j < 4 else 1
    a = a[(slice(None),) * lead + (_rows(rank, shape, a.shape[lead]),)]
    n, i = shape[1], rank % shape[1]
    d_inner, nh = (ssm_dims(cfg) if arch == ZAMBA else xlstm_dims(cfg))[:2]
    assert nh % n == 0
    if (arch, j) in ((ZAMBA, 1), (XLSTM, 3)):       # the conv tails
        k = d_inner // n
        keep = np.arange(i * k, (i + 1) * k)
        if arch == ZAMBA:
            keep = np.concatenate([keep, np.arange(
                d_inner, d_inner + 2 * cfg.ssm.state_dim)])
        return a[..., keep]
    k = nh // n
    return a[(slice(None),) * (lead + 1) + (slice(i * k, (i + 1) * k),)]


def _tokens(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, size=(b, SEQ)).astype(np.int32),
        labels=rng.integers(0, cfg.vocab_size, size=(b, SEQ)).astype(np.int32),
        positions=np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                  (b, SEQ)).copy())


def _train_batch(cfg, b, seed):
    out = _tokens(cfg, b, seed)
    out["labels"][0, :3] = -1
    out["labels"][-1, -2:] = -1
    return out


def _params_tree(arch):
    """JAX ``init_params`` weights as numpy (bf16 as ``ml_dtypes``), with
    Mamba2's per-head constants (``conv_b``, ``dt_bias``, ``A_log``,
    ``D``, the same in every head at init) drawn at random."""
    import jax

    from repro.models import model as JM
    cfg, _ = _configs(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    if arch == ZAMBA:
        mamba = tree["mamba_layers"]["mamba"]
        rng = np.random.default_rng(3)
        for name, scale, shift in (("conv_b", 0.5, 0.0),
                                   ("dt_bias", 0.5, -2.0),
                                   ("A_log", 0.5, 0.5), ("D", 0.5, 1.0)):
            mamba[name] = (rng.normal(size=mamba[name].shape) * scale
                           + shift).astype(mamba[name].dtype)
    return tree


def _jax_tree(flat, prefix, dtype):
    """The ``prefix`` leaves of the inputs as JAX arrays; f32 widened."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    tree = jax.tree.map(lambda a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a),
        _unflatten(flat, prefix))
    if dtype == "float32":      # the same weights widened (exact)
        tree = jax.tree.map(lambda a: a.astype(jnp.float32), tree)
    return tree


def _port_params(flat, arch, dtype):
    """(port config, the case's weights): copies, not views of the
    inputs, which a step's in-place update of a leaf no axis splits (each
    rank's shard shares it) would otherwise change for the later cases."""
    from repro_torch.bridge import params_from_numpy
    _, cfg = _configs(arch)
    prefix = f"{arch}/params/"
    full = params_from_numpy(_unflatten({
        k: v.copy() for k, v in flat.items() if k.startswith(prefix)},
        prefix), cfg, "cpu")
    if dtype == "float32":
        full = _unflatten({k: v.float() for k, v in
                           _flatten(full, "").items()}, "")
    return cfg, full


def _pools(rng, cfg):
    """Zamba2's f32 pools over 4 shards: the rows' blocks at ``POS`` over
    ``STEPS`` steps in shuffled slots, 4 free slots of garbage.  Returns
    the arrays and per step the append slots and offsets."""
    from repro.models import model as JM
    L, nkv, hd = JM.num_kv_layers(cfg), cfg.num_kv_heads, cfg.resolved_head_dim
    owned = [(r, j) for r, p in enumerate(POS)
             for j in range((p + STEPS - 1) // BS + 1)]
    n = -(-(len(owned) + 4) // 4) * 4
    slots = rng.permutation(n)[:len(owned)]
    out = dict(k=rng.normal(size=(L, n, BS, nkv, hd)).astype(np.float32),
               v=rng.normal(size=(L, n, BS, nkv, hd)).astype(np.float32),
               sr=np.full((n,), -1, np.int32),
               sb=rng.integers(0, 256, size=n).astype(np.int32))
    where = {}
    for (r, j), s in zip(owned, slots):
        out["sr"][s], out["sb"][s] = r, j * BS
        where[(r, j)] = int(s)
    p = np.asarray(POS, np.int32)[None] + np.arange(STEPS, dtype=np.int32)[
        :, None]
    out["pos"] = p
    out["aslot"] = np.asarray([[where[(r, q // BS)] for r, q in
                               enumerate(row)] for row in p], np.int32)
    out["aoff"] = (p % BS).astype(np.int32)
    return out


def _build_inputs(path):
    """Every case's inputs: the weights, the training batches, and for
    decode the tokens fed, zamba2's pools, and the states an unsharded JAX
    prefill of the rows leaves (each leaf as numpy, bf16 as its bits)."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    flat = {}
    for arch in LAYERS:
        flat.update(_flatten(jax.tree.map(_bits, _params_tree(arch)),
                             f"{arch}/params/"))
    for i, (case, (arch, _, _, b)) in enumerate(TRAIN.items()):
        cfg, _ = _configs(arch)
        for step in range(2):
            for k, v in _train_batch(cfg, b, 100 + 10 * i + step).items():
                flat[f"train/{case}/batch{step}/{k}"] = v
    for i, (case, (arch, dtype)) in enumerate(PREFILL.items()):
        cfg, _ = _configs(arch)
        for k, v in _tokens(cfg, B, 300 + i).items():
            if k != "labels":
                flat[f"prefill/{case}/{k}"] = v
    for i, (case, (arch, dtype)) in enumerate(DECODE.items()):
        cfg, _ = _configs(arch)
        rng = np.random.default_rng(500 + i)
        params = _jax_tree(flat, f"{arch}/params/", dtype)
        b = {k: jnp.asarray(v) for k, v in _tokens(cfg, B, 400 + i).items()
             if k != "labels"}
        _, out = jax.jit(lambda p, b, cfg=cfg: JM.prefill(p, b, cfg))(
            params, b)
        for j, t in enumerate(jax.tree.leaves(out.states)):
            flat[f"decode/{case}/states/{j}"] = _bits(t)
        flat[f"decode/{case}/tokens"] = rng.integers(
            0, cfg.vocab_size, size=(STEPS, B)).astype(np.int32)
        if arch == ZAMBA:
            for k, v in _pools(rng, cfg).items():
                flat[f"decode/{case}/{k}"] = v
    np.savez(path, **flat)


def _case(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the JAX reference (this file run as a script, in its own process)
# ---------------------------------------------------------------------------


def _jax_states(JM, arch, g):
    """The decode states of the inputs ``g`` as the JAX package's tuple."""
    import jax.numpy as jnp
    import ml_dtypes

    from repro.models import ssm as JS
    from repro.models import xlstm as JX
    leaves = [g[f"states/{j}"] for j in range(len(
        [k for k in g if k.startswith("states/")]))]
    leaves = [jnp.asarray(a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16
                          else a) for a in leaves]
    if arch == ZAMBA:
        return JS.SSMState(*leaves)
    return JX.MLSTMState(*leaves[:4]), JX.SLSTMState(*leaves[4:])


def _jax_reference(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_rules
    from repro.models import model as JM
    from repro.train import optim as JO

    inp = dict(np.load(inputs_path))
    out = {}
    meshes = {}

    def rules_of(shape):
        if shape not in meshes:
            meshes[shape] = make_rules(jax.make_mesh(
                shape, AXES, axis_types=(jax.sharding.AxisType.Auto,) * 2))
        return meshes[shape]

    f32 = lambda a: np.asarray(a, np.float32)    # noqa: E731
    for case, (arch, dtype, shape, _) in TRAIN.items():
        cfg, _ = _configs(arch)
        rules = rules_of(shape)
        params = _jax_tree(inp, f"{arch}/params/", dtype)
        batches = [{k: jnp.asarray(v) for k, v in _case(
            inp, f"train/{case}/batch{s}/").items()} for s in range(2)]
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg: JM.loss_fn(p, b, cfg, rules),
            has_aux=True))(params, batches[0])
        pre = f"train/{case}"
        out.update({f"{pre}/grads/{k}": f32(v)
                    for k, v in _flatten(grads, "").items()})
        out[f"{pre}/nll"] = np.asarray(float(metrics["nll"]))
        step = jax.jit(lambda p, o, b, cfg=cfg: JO.train_step(
            p, o, b, cfg, rules, lr=LR))
        opt = JO.adamw_init(params)
        for s in range(2):
            params, opt, m = step(params, opt, batches[s])
            for k, v in m.items():
                out[f"{pre}/step{s}/{k}"] = np.asarray(v)
            for name, tree in (("mu", opt.mu), ("nu", opt.nu)):
                out.update({f"{pre}/step{s}/{name}/{k}": f32(v)
                            for k, v in _flatten(tree, "").items()})
        out.update({f"{pre}/params/{k}": f32(v)
                    for k, v in _flatten(params, "").items()})

    rules = rules_of(MESH)
    for case, (arch, dtype) in PREFILL.items():
        cfg, _ = _configs(arch)
        params = _jax_tree(inp, f"{arch}/params/", dtype)
        b = {k: jnp.asarray(v) for k, v in _case(inp, f"prefill/{case}/")
             .items()}
        last, fo = jax.jit(lambda p, b, cfg=cfg: JM.prefill(p, b, cfg,
                                                            rules))(params, b)
        out[f"prefill/{case}/logits"] = f32(last)
        if fo.kv is not None:
            out[f"prefill/{case}/k"], out[f"prefill/{case}/v"] = (
                f32(t) for t in fo.kv)
        for j, t in enumerate(jax.tree.leaves(fo.states)):
            out[f"prefill/{case}/states/{j}"] = f32(t)

    for case, (arch, dtype) in DECODE.items():
        cfg, _ = _configs(arch)
        params = _jax_tree(inp, f"{arch}/params/", dtype)
        g = _case(inp, f"decode/{case}/")
        zero = jnp.zeros((B,), jnp.int32)
        kv = None
        if arch == ZAMBA:
            kv = JM.KVPools(*(jnp.asarray(g[k]) for k in ("k", "v", "sr",
                                                          "sb")), zero, zero)
        st = JM.DecodeState(tokens=None, pos=None, kv=kv, peer=None,
                            states=_jax_states(JM, arch, g))
        step = jax.jit(lambda p, s, cfg=cfg: JM.serve_step(p, s, cfg, rules))
        logs = []
        for t in range(STEPS):
            pos = jnp.asarray(g["pos"][t]) if arch == ZAMBA else \
                jnp.asarray(np.asarray(POS, np.int32) + t)
            st = st._replace(tokens=jnp.asarray(g["tokens"][t]), pos=pos)
            if kv is not None:
                st = st._replace(kv=st.kv._replace(
                    append_slot=jnp.asarray(g["aslot"][t]),
                    append_off=jnp.asarray(g["aoff"][t])))
            logits, st = step(params, st)
            logs.append(f32(logits))
        out[f"decode/{case}/logits"] = np.stack(logs)
        for j, t in enumerate(jax.tree.leaves(st.states)):
            out[f"decode/{case}/states/{j}"] = f32(t)
        if kv is not None:
            out[f"decode/{case}/pool_k"] = f32(st.kv.pool_k)
            out[f"decode/{case}/pool_v"] = f32(st.kv.pool_v)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port (4 gloo ranks)
# ---------------------------------------------------------------------------


def _leaves_np(states):
    """The states' leaves in the JAX package's order, as f32 numpy."""
    if isinstance(states, tuple) and hasattr(states, "_fields"):
        return [t.float().numpy() for t in states]
    return [t.float().numpy() for st in states for t in st]


def _train_case(case, inp, rules, rank, unsharded=True):
    """One training case on this rank: the first step's metrics and
    gradients (gathered), then two ``train_step(..., rules)`` calls;
    rank 0 gathers the moments and parameters, and where ``unsharded``
    the port's own unsharded loss and gradients."""
    from repro_torch.bridge import gather_train, shard_train
    from repro_torch.models import model as TM
    from repro_torch.train import optim as O

    arch, dtype, _, _ = TRAIN[case]
    cfg, full = _port_params(inp, arch, dtype)
    batches = [{k: torch.from_numpy(v) for k, v in _case(
        inp, f"train/{case}/batch{s}/").items()} for s in range(2)]
    p, _ = shard_train(full, None, cfg, rules)
    res = {}
    if rank == 0 and unsharded:
        res["unsharded"] = _unsharded_grads(TM, O, full, batches[0], cfg)
    res["metrics"], res["gnorm"], res["grads"] = _sharded_grads(
        TM, O, p, batches[0], cfg, rules)
    opt = O.adamw_init(p)
    res["steps"], res["whole"] = [], []
    for s in range(2):
        p, opt, m = O.train_step(p, opt, batches[s], cfg, rules, lr=LR)
        res["steps"].append({k: float(v) for k, v in m.items()})
        res["whole"].append(_whole_leaves(O, TM, p, cfg, rules))
        _, of = gather_train(p, opt, cfg, rules)
        if rank == 0:
            for name, tree in (("mu", of.mu), ("nu", of.nu)):
                res[f"step{s}/{name}"] = {k: v.numpy() for k, v in
                                          _flatten(tree, "").items()}
    pf, _ = gather_train(p, None, cfg, rules)
    if rank == 0:
        res["params"] = {k: v.float().numpy()
                         for k, v in _flatten(pf, "").items()}
    return res


def _prefill_case(case, inp, rules):
    """``prefill(rules)`` of the rank's shard on the global rows: its
    rows' logits, KV and final states."""
    from repro_torch.bridge import shard_train
    from repro_torch.models import model as TM

    arch, dtype = PREFILL[case]
    cfg, full = _port_params(inp, arch, dtype)
    p, _ = shard_train(full, None, cfg, rules)
    b = {k: torch.from_numpy(v) for k, v in _case(inp, f"prefill/{case}/")
         .items()}
    last, fo = TM.prefill(p, b, cfg, rules)
    res = {"logits": last.float().numpy(), "states": _leaves_np(fo.states)}
    if fo.kv is not None:
        res["k"], res["v"] = (t.float().numpy() for t in fo.kv)
    return res


def _port_states(arch, g):
    from repro_torch.bridge import numpy_to_tensor
    from repro_torch.models import ssm as TS
    from repro_torch.models import xlstm as TX
    n = len([k for k in g if k.startswith("states/")])
    leaves = [g[f"states/{j}"] for j in range(n)]
    leaves = [numpy_to_tensor(a, "bfloat16" if a.dtype == np.uint16
                              else a.dtype.name, "cpu") for a in leaves]
    if arch == ZAMBA:
        return TS.SSMState(*leaves)
    return TX.MLSTMState(*leaves[:4]), TX.SLSTMState(*leaves[4:])


def _decode(TM, params, st, cfg, arch, g, rules):
    logs = []
    for t in range(STEPS):
        pos = g["pos"][t] if arch == ZAMBA else \
            np.asarray(POS, np.int32) + t
        st = st._replace(tokens=torch.from_numpy(g["tokens"][t]),
                         pos=torch.from_numpy(np.ascontiguousarray(pos)))
        if st.kv is not None:
            st = st._replace(kv=st.kv._replace(
                append_slot=torch.from_numpy(g["aslot"][t]),
                append_off=torch.from_numpy(g["aoff"][t])))
        logits, st = TM.serve_step(params, st, cfg, rules=rules)
        logs.append(logits.float().numpy())
        want_tokens = np.argmax(logs[-1], -1)
        if rules is not None:
            # the tokens come back whole: this rank's rows are its argmax
            rows = _rows(rules.mesh.rank)
            assert st.tokens.shape == (B,)
            assert np.array_equal(st.tokens.numpy()[rows], want_tokens)
    return np.stack(logs), st


def _decode_case(case, inp, rules, rank):
    """Four ``serve_step(rules)`` steps of this rank's shard
    (``bridge.shard_decode``: its slots of the pools, its rows of the
    states); on rank 0 the port's unsharded steps too."""
    from repro_torch.bridge import shard_decode
    from repro_torch.models import model as TM

    arch, dtype = DECODE[case]
    cfg, params = _port_params(inp, arch, dtype)
    g = _case(inp, f"decode/{case}/")
    zero = torch.zeros((B,), dtype=torch.int32)
    kv = None
    if arch == ZAMBA:
        kv = TM.KVPools(*(torch.from_numpy(g[k].copy()) for k in (
            "k", "v", "sr", "sb")), zero, zero)
    full = TM.DecodeState(tokens=torch.from_numpy(g["tokens"][0]),
                          pos=torch.zeros((B,), dtype=torch.int32), kv=kv,
                          peer=None, states=_port_states(arch, g))
    p_r, st_r = shard_decode(params, full, cfg, rules)
    res = {"state_rows": [t.shape for t in _leaves_np(st_r.states)]}
    logs, st = _decode(TM, p_r, st_r, cfg, arch, g, rules)
    res["logits"], res["states"] = logs, _leaves_np(st.states)
    if kv is not None:
        res["pool_k"], res["pool_v"] = st.kv.pool_k.numpy(), \
            st.kv.pool_v.numpy()
    if rank == 0:
        logs, st = _decode(TM, params, full, cfg, arch, g, None)
        res["unsharded"] = {"logits": logs, "states": _leaves_np(st.states)}
        if kv is not None:
            res["unsharded"]["pool_k"] = st.kv.pool_k.numpy()
            res["unsharded"]["pool_v"] = st.kv.pool_v.numpy()
    return res


def _port_ranks(rank, world, inputs_path):
    """Every case on this rank."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, make_rules

    inp = dict(np.load(inputs_path))
    meshes = {shape: make_rules(Mesh(shape, AXES))
              for shape in dict.fromkeys([MESH] + [s for _, _, s, _ in
                                                   TRAIN.values()])}
    out = {"coords": meshes[MESH].mesh.coords}
    for case, (_, _, shape, _) in TRAIN.items():
        out[f"train/{case}"] = _train_case(
            case, inp, _without_tensor_parallelism(meshes[shape]), rank)
    for case in TP_TRAIN:
        out[f"tp/{case}"] = _train_case(case, inp, meshes[TRAIN[case][2]],
                                        rank, unsharded=False)
    for case in PREFILL:
        out[f"prefill/{case}"] = _prefill_case(case, inp, meshes[MESH])
    for case in DECODE:
        out[f"decode/{case}"] = _decode_case(case, inp, meshes[MESH], rank)
    from repro_torch.train.loop import train
    for arch in LAYERS:       # the loop on the mesh, reduced() as the CLI's
        _, _, hist = train(_configs(arch)[1], steps=2, batch=B,
                           seq_len=16, lr=LR, seed=2, rules=meshes[MESH],
                           log_every=1, device="cpu")
        out[f"loop/{arch}"] = [{k: float(v) for k, v in h.items()
                                if k != "tok_s"} for h in hist]
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each port rank's results, the inputs)."""
    from repro_torch.launch.mesh import launch

    tmp = tmp_path_factory.mktemp("recurrent_mesh")
    inputs, jax_out = tmp / "inputs.npz", tmp / "jax.npz"
    _build_inputs(inputs)
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, __file__, "--jax-reference", str(inputs),
         str(jax_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch(_port_ranks, 4, (str(inputs),), timeout=TIMEOUT_S)
    finally:
        log, _ = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, log[-4000:]
    return dict(np.load(jax_out)), ranks, dict(np.load(inputs))


def _hold(got, want, rel, what):
    """``got`` has ``want``'s shape and lies within ``rel`` of its largest
    entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def test_ranks_are_the_mesh(runs):
    _, ranks, _ = runs
    assert [r["coords"] for r in ranks] == [
        {"data": i, "model": j} for i in range(2) for j in range(2)]


@pytest.mark.parametrize("case", list(TRAIN))
def test_sharded_gradients_match_jax(runs, case):
    """The first step's nll and every gradient (gathered whole) against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` under the same mesh's
    rules; every rank gathers the same gradients."""
    _check_gradients(runs, case, f"train/{case}")


@pytest.mark.parametrize("case", TP_TRAIN)
def test_tensor_parallel_gradients_match_jax(runs, case):
    """The same, tensor-parallel over ``model`` (the default rules)."""
    _check_gradients(runs, case, f"tp/{case}")


def _check_gradients(runs, case, port_key):
    ref, ranks, _ = runs
    dtype = TRAIN[case][1]
    key = f"train/{case}"
    r0 = ranks[0][port_key]
    want = _case(ref, f"{key}/grads/")
    _hold_tree(r0["grads"], want,
               F32_REL if dtype == "float32" else BF16_JAX_GRAD_REL, "grads")
    np.testing.assert_allclose(
        r0["metrics"]["nll"], float(ref[f"{key}/nll"]),
        rtol=F32_REL if dtype == "float32" else BF16_LOSS_REL)
    for r in ranks[1:]:
        for k, g in r[port_key]["grads"].items():
            assert np.array_equal(g, r0["grads"][k]), k


@pytest.mark.parametrize("case", list(TRAIN))
def test_sharded_train_steps_match_jax(runs, case):
    """Two ``train_step(..., rules)`` calls against JAX's jitted
    ``train_step`` on the same mesh: each step's loss, nll and grad_norm,
    ``mu`` and ``nu`` after each step and every parameter after the
    second, gathered; every rank the same metrics and the same bits of
    every leaf no axis splits.  f32: the first step's moments within
    ``F32_REL`` of each leaf's largest entry, the second's and the
    parameters as ``MOMENT2_REL`` says; bf16: ``BF16_MOMENT_REL`` and each
    parameter within 2 lr a step plus a bf16 step of its size."""
    _check_steps(runs, case, f"train/{case}")


@pytest.mark.parametrize("case", TP_TRAIN)
def test_tensor_parallel_train_steps_match_jax(runs, case):
    """The same, tensor-parallel over ``model`` (the default rules): the
    f32 first step's ``nu`` within ``TP_F32_NU0_REL``, bf16 moments
    within ``TP_BF16_MOMENT_REL``."""
    _check_steps(runs, case, f"tp/{case}", TP_F32_NU0_REL,
                 TP_BF16_MOMENT_REL)


def _check_steps(runs, case, port_key, f32_nu0_rel=F32_REL,
                 bf16_moment_rel=BF16_MOMENT_REL):
    ref, ranks, _ = runs
    f32 = TRAIN[case][1] == "float32"
    key = f"train/{case}"
    r0 = ranks[0][port_key]
    for s in range(2):
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(
                r0["steps"][s][k], float(ref[f"{key}/step{s}/{k}"]),
                rtol=F32_REL if f32 else BF16_GNORM_REL if k == "grad_norm"
                else BF16_LOSS_REL, err_msg=f"step {s} {k}")
    for r in ranks[1:]:
        assert r[port_key]["steps"] == r0["steps"]
        assert r[port_key]["whole"] == r0["whole"]
    for s in range(2):
        for name in ("mu", "nu"):
            first = f32_nu0_rel if name == "nu" else F32_REL
            rel = (first if s == 0 else MOMENT2_REL) if f32 else \
                bf16_moment_rel[name]
            _hold_tree(r0[f"step{s}/{name}"],
                       _case(ref, f"{key}/step{s}/{name}/"), rel,
                       f"step {s} {name}")
    want = _case(ref, f"{key}/params/")
    assert r0["params"].keys() == want.keys()
    off = total = 0
    for k, w in want.items():
        g = r0["params"][k]
        d = np.abs(g - w)
        if f32:
            assert d.max() <= 2 * LR * 2, k
            off += int((d > 2e-6).sum())
            total += d.size
        else:
            assert np.all(d <= 2 * LR * 2 + 2.0 ** -7 * np.maximum(
                np.abs(g), np.abs(w))), k
    assert off <= PARAMS_OFF_SHARE * total, (off, total)


@pytest.mark.parametrize("case", list(TRAIN))
def test_sharded_matches_unsharded_port(runs, case):
    """The sharded pass is the unsharded pass: in f32 nll, the norm and
    every gradient within ``UNSHARDED_REL``; in bf16 (the ranks' sums
    over ``data`` round once in f32, one device's add by add) the nll and
    the norm within ``BF16_LOSS_REL``, every gradient within
    ``BF16_GRAD_REL``."""
    _, ranks, _ = runs
    r0 = ranks[0][f"train/{case}"]
    um, ugnorm, ugrads = r0["unsharded"]
    f32 = TRAIN[case][1] == "float32"
    tol = UNSHARDED_REL if f32 else BF16_LOSS_REL
    np.testing.assert_allclose(r0["metrics"]["nll"], um["nll"], rtol=tol)
    np.testing.assert_allclose(r0["gnorm"], ugnorm, rtol=tol)
    _hold_tree(r0["grads"], ugrads, UNSHARDED_REL if f32 else BF16_GRAD_REL,
               "grads")


@pytest.mark.parametrize("case", TP_TRAIN)
def test_tensor_parallel_matches_unsharded_port(runs, case):
    """The same, tensor-parallel over ``model``: in f32 within
    ``TP_UNSHARDED_REL`` (the ranks' partial products round apart before
    their sum), in bf16 the nll and the norm as above and every gradient
    within ``TP_BF16_GRAD_REL``."""
    _, ranks, _ = runs
    r0 = ranks[0][f"tp/{case}"]
    um, ugnorm, ugrads = ranks[0][f"train/{case}"]["unsharded"]
    f32 = TRAIN[case][1] == "float32"
    tol = TP_UNSHARDED_REL if f32 else BF16_LOSS_REL
    np.testing.assert_allclose(r0["metrics"]["nll"], um["nll"], rtol=tol)
    np.testing.assert_allclose(r0["gnorm"], ugnorm, rtol=tol)
    _hold_tree(r0["grads"], ugrads, TP_UNSHARDED_REL if f32 else
               TP_BF16_GRAD_REL, "grads")


@pytest.mark.parametrize("case", list(PREFILL))
def test_sharded_prefill_matches_jax(runs, case):
    """``prefill(rules)``: each rank's rows (its data index's half of the
    batch) of JAX's sharded prefill: the last-token logits, zamba2's
    stacked k and v, every final state its rows' and heads'
    (``_state_cut``) (f32 within ``F32_REL`` of each tensor's largest
    entry, bf16 within ``BF16_REL``)."""
    ref, ranks, _ = runs
    arch, dtype = PREFILL[case]
    rel = F32_REL if dtype == "float32" else BF16_REL
    key = f"prefill/{case}"
    n_states = len(_case(ref, f"{key}/states/"))
    for rank, r in enumerate(ranks):
        got, rows = r[key], _rows(rank)
        _hold(got["logits"], ref[f"{key}/logits"][rows], rel, "logits")
        if arch == ZAMBA:
            for name in ("k", "v"):
                _hold(got[name], ref[f"{key}/{name}"][:, rows], rel, name)
        else:
            assert "k" not in got
        assert len(got["states"]) == n_states
        for j, g in enumerate(got["states"]):
            _hold(g, _state_cut(arch, j, ref[f"{key}/states/{j}"], rank),
                  rel, f"state {j}")


def _check_bf16_logits(want, got, ties=()):
    from test_torch_engine import _check_sampled_logits
    _check_sampled_logits(list(want.reshape(-1, want.shape[-1])),
                          list(got.reshape(-1, got.shape[-1])), ties)


def _decode_rows(ranks, key, what):
    """The logits of every row, each from the first rank of its data
    index (the model ranks of one data index compute alike)."""
    for i in range(MESH[0]):
        for j in range(1, MESH[1]):
            assert np.array_equal(ranks[i * MESH[1] + j][key][what],
                                  ranks[i * MESH[1]][key][what])
    return np.concatenate([ranks[i * MESH[1]][key][what]
                           for i in range(MESH[0])], axis=1)


@pytest.mark.parametrize("case", list(DECODE))
def test_sharded_serve_step_matches_jax(runs, case):
    """Four ``serve_step(rules)`` steps against JAX's sharded
    ``serve_step``: each rank holds its rows' states alone (the batch
    over ``data``), of its heads alone (the heads over ``model``), its
    rows' logits held to JAX's (f32 within ``F32_REL`` of the largest;
    bf16 under tests/test_torch_engine.py's near-tie guard, the tokens
    identical), its rows' and heads' new states (``_state_cut``), and
    zamba2's pool shards against the matching slots of JAX's pools."""
    ref, ranks, inp = runs
    arch, dtype = DECODE[case]
    key = f"decode/{case}"
    logs = _decode_rows(ranks, key, "logits")
    want = ref[f"{key}/logits"]
    if dtype == "float32":
        _hold(logs, want, F32_REL, "logits")
    else:
        _check_bf16_logits(want, logs, KNOWN_NEAR_TIES.get(case, ()))
        assert np.array_equal(logs.argmax(-1), want.argmax(-1))
    rel = F32_REL if dtype == "float32" else BF16_REL
    for rank, r in enumerate(ranks):
        got = r[key]
        for j, g in enumerate(got["states"]):
            w = ref[f"{key}/states/{j}"]
            lead = 2 if arch == XLSTM and j < 4 else 1
            w = _state_cut(arch, j, w, rank)
            assert got["state_rows"][j] == w.shape
            assert w.shape[lead] == B // MESH[0]
            _hold(g, w, rel, f"rank {rank} state {j}")
        if arch == ZAMBA:
            n = inp[f"{key}/sr"].shape[0] // 4
            sl = slice(rank * n, (rank + 1) * n)
            for name in ("pool_k", "pool_v"):
                _hold(got[name], ref[f"{key}/{name}"][:, sl], rel, name)


@pytest.mark.parametrize("case", list(DECODE))
def test_sharded_serve_step_matches_unsharded(runs, case):
    """The same steps against the port's own unsharded step on rank 0:
    f32 logits, states and pools within ``UNSHARDED_REL`` of each
    tensor's largest entry; bf16 the tokens identical under the near-tie
    guard.  The ranks' pool shards together are the unsharded pools."""
    _, ranks, _ = runs
    arch, dtype = DECODE[case]
    key = f"decode/{case}"
    un = ranks[0][key]["unsharded"]
    logs = _decode_rows(ranks, key, "logits")
    if dtype == "float32":
        _hold(logs, un["logits"], UNSHARDED_REL, "logits")
    else:
        _check_bf16_logits(un["logits"], logs)
    rel = UNSHARDED_REL if dtype == "float32" else BF16_REL
    for rank, r in enumerate(ranks):
        for j, g in enumerate(r[key]["states"]):
            _hold(g, _state_cut(arch, j, un["states"][j], rank), rel,
                  f"rank {rank} state {j}")
    if arch == ZAMBA:
        for name in ("pool_k", "pool_v"):
            got = np.concatenate([r[key][name] for r in ranks], axis=1)
            _hold(got, un[name], rel, name)


@pytest.mark.parametrize("arch", list(LAYERS))
def test_train_loop_on_a_mesh(runs, arch):
    """``train(..., rules=rules)`` (what ``launch.train --mesh`` runs) on
    the (2, 2) mesh: every rank the same finite history, and the first
    step's nll the unsharded loop's (the same draws, the same global
    batch; bf16 weights)."""
    from repro_torch.train.loop import train
    _, ranks, _ = runs
    hist = ranks[0][f"loop/{arch}"]
    assert all(r[f"loop/{arch}"] == hist for r in ranks[1:])
    assert [h["step"] for h in hist] == [0, 1]
    assert np.isfinite([h["loss"] for h in hist]).all()
    _, _, ref = train(_configs(arch)[1], steps=1, batch=B, seq_len=16, lr=LR,
                      seed=2, log_every=1, device="cpu")
    np.testing.assert_allclose(hist[0]["nll"], ref[0]["nll"],
                               rtol=BF16_LOSS_REL)


def test_ssd_gradient_is_finite_past_exp_range():
    """Mamba2's chunked SSD over a chunk whose log-decays span past exp's
    range (dt A summing to about -380 over 64 tokens; full-width
    zamba2-7b's 256-token chunks reach such spans and gave NaN gradients
    on the card): the port's output and final state equal the JAX
    package's, and its gradient is finite.  The JAX package's
    ``where(mask, exp(diff), 0)`` takes the exp of the masked-away
    differences too, and its gradient there is NaN (0 * inf), which the
    port's mask before the exp avoids."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as JS
    from repro_torch.models import ssm as TS

    rng = np.random.default_rng(0)
    b, s, nh, hd, n, chunk = 1, 64, 2, 4, 8, 64
    xh, B_, C_ = (rng.normal(size=shape).astype(np.float32) for shape in
                  ((b, s, nh, hd), (b, s, n), (b, s, n)))
    dt = rng.uniform(2.0, 4.0, size=(b, s, nh)).astype(np.float32)
    A = np.asarray([-2.0, -1.5], np.float32)

    def jloss(xh, dt):
        y, st = JS._ssd_chunked(xh, dt, jnp.asarray(A), jnp.asarray(B_),
                                jnp.asarray(C_), chunk)
        return jnp.sum(y) + jnp.sum(st), (y, st)

    (_, (jy, jst)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(xh, dt)
    t = [torch.from_numpy(a.copy()).requires_grad_() for a in (xh, dt)]
    ty, tst = TS._ssd_chunked(t[0], t[1], torch.from_numpy(A),
                              torch.from_numpy(B_), torch.from_numpy(C_),
                              chunk)
    tg = torch.autograd.grad(ty.sum() + tst.sum(), t)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst.detach().numpy(), np.asarray(jst),
                               rtol=1e-5, atol=1e-5)
    assert all(torch.isfinite(g).all() for g in tg)
    assert any(np.isnan(np.asarray(g)).any() for g in jg)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-reference"]:
    _jax_reference(sys.argv[2], sys.argv[3])
