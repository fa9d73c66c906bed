"""Training on a mesh of ranks, held to the JAX package's sharded
``train_step`` on the same (data, model) mesh.

The port's side: ``core.collectives``' differentiable collectives,
``models.sharding.train_spec`` and ``gather_fsdp``, ``bridge.shard_train``
and ``gather_train``, ``init_params(..., rules)``, ``forward`` /
``loss_fn(..., rules)`` (each rank its rows, FSDP gathers inside each
block's recompute region, ``moe._moe_layer_train``), ``train_step(...,
rules)`` (gradient sums, the sharded global norm, AdamW on the shards),
``train(..., rules=rules)`` and the checkpoints it writes.

The JAX reference runs in one subprocess, this file run as a script:
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before jax
loads, meshes of Auto axes (Explicit axes make ``shard`` refuse its
constraints), ``jax.jit`` of ``value_and_grad(loss_fn)`` and of
``train_step`` with ``make_rules(mesh)``.  The port runs in one launch of
4 gloo ranks on the CPU.  The fixture starts both at once; they read the
same inputs (``inputs.npz``: the JAX package's ``init_params`` weights and
numpy batches).

Cases (``CASES``): reduced phi-tiny-moe on (data 2, model 2) in f32 and
bf16, on (data 4, model 1), and with a batch of 3 rows that does not
divide over ``data`` (JAX's global MoE path; every rank runs every row);
qwen2-moe (a shared expert), Llama-4 at 4 layers with ``layer_period`` 2
(the interleaved pairs) and yi-6b (dense, f32 and bf16) on (2, 2), each
with data parallelism, FSDP and expert parallelism and tensor
parallelism off (``_without_tensor_parallelism``).  The cases of
``TP_CASES`` run again under the default rules, tensor-parallel over
``model``, held to the same JAX runs at tests/test_torch_tensor_parallel.py's
bounds (yi-6b and qwen2-moe are held there).  Held: loss, nll, aux and
grad_norm, every gradient, and after two steps every parameter, ``mu``
and ``nu``, gathered; every rank's whole leaves equal.  The collectives alone
against JAX's transposes of the same ``shard_map`` over 2 and 4 ranks,
and the schema's logical axes and splits against JAX's for every family.
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

AXES = ("data", "model")
LLAMA4 = "llama4-maverick-400b-a17b"
SEQ = 16
LR = 1e-3
#: case -> (arch, dtype, mesh shape, batch rows)
CASES = {
    "phi-tiny-moe-f32": ("phi-tiny-moe", "float32", (2, 2), 4),
    "phi-tiny-moe-bf16": ("phi-tiny-moe", "bfloat16", (2, 2), 4),
    "phi-tiny-moe-4x1-f32": ("phi-tiny-moe", "float32", (4, 1), 4),
    # 3 rows over 2 data ranks: JAX's global MoE path, rows replicated
    "phi-tiny-moe-odd-f32": ("phi-tiny-moe", "float32", (2, 2), 3),
    "qwen2-moe-f32": ("qwen2-moe", "float32", (2, 2), 4),
    "llama4-f32": (LLAMA4, "float32", (2, 2), 4),
    "yi-6b-f32": ("yi-6b", "float32", (2, 2), 4),
    "yi-6b-bf16": ("yi-6b", "bfloat16", (2, 2), 4),
}
#: bf16 MoE cases whose port runs replay JAX's routing, device by device
#: and call by call: a bf16 step moves the router's near ties
REPLAYED = ("phi-tiny-moe-bf16",)
#: (call, row) of each rank's routing calls where JAX's sharded bf16
#: router chose otherwise than the port's own (calls 0-3: the gradient's
#: pass and recompute, 4-11: the two steps'; each pass's calls are layer
#: 0, layer 1, then the recompute's layer 1, layer 0); each a near tie.
#: Data shard 0's row 1 at layer 0 in the first two passes: gaps log
#: p_2 / p_3 of 0.0031 (the port) and 0.0022 (JAX), its log-probabilities
#: 0.0036 apart; at the second step's weights the two route it alike
_ROW1 = [(0, 1), (3, 1), (4, 1), (7, 1)]
KNOWN_ROUTER_TIES = {("phi-tiny-moe-bf16", 0): _ROW1,
                     ("phi-tiny-moe-bf16", 1): _ROW1}
#: the same, tensor-parallel over ``model``: those rows, and data shard
#: 0's row 5 at layer 1 in the second step's pass and its recompute
#: (calls 9 and 10): gaps of 0.0001 (the port) and 0.0037 (JAX), its
#: log-probabilities 0.0067 apart
_TP_TIES = _ROW1 + [(9, 5), (10, 5)]
KNOWN_TP_ROUTER_TIES = {("phi-tiny-moe-bf16", 0): _TP_TIES,
                        ("phi-tiny-moe-bf16", 1): _TP_TIES}
#: the cases run a second time with tensor parallelism over ``model``
#: (the default rules): those whose mesh has more than one ``model``
#: rank and that tests/test_torch_tensor_parallel.py does not hold (its
#: yi-6b f32 and bf16 and qwen2-moe f32 on (2, 2) are these configs)
TP_CASES = ("phi-tiny-moe-f32", "phi-tiny-moe-bf16", "phi-tiny-moe-odd-f32",
            "llama4-f32")
#: ... their bounds where tensor parallelism's roundings add to those
#: above (tests/test_torch_tensor_parallel.py's): bf16 gradients against
#: JAX, the bf16 gradient norm, and the f32 pass against the unsharded
#: port (the ranks' partial products round apart before their sum)
TP_BF16_GRAD_REL = 2.0 ** -4
TP_BF16_GNORM_REL = 1e-2
TP_UNSHARDED_REL = 1e-5
#: the logical axes that tensor parallelism splits over ``model``
TENSOR_PARALLEL_AXES = ("heads", "kv_heads", "ff", "vocab", "act_heads",
                        "act_ff", "act_embed")
#: the cases also held against the port's own unsharded loss and
#: gradients at the reduced configs' lossless capacity (factor 8.0)
UNSHARDED = ("phi-tiny-moe-f32", "phi-tiny-moe-4x1-f32",
             "phi-tiny-moe-odd-f32", "qwen2-moe-f32", "llama4-f32",
             "yi-6b-f32")
#: f32: each gradient, parameter and moment within this much of its
#: leaf's largest entry; losses and the norm to this relative tolerance
F32_REL = 1e-5
#: bf16 gradients per leaf: tests/test_torch_train_grads.py's
#: BF16_GRAD_REL (two bf16 steps of the leaf's largest entry)
BF16_GRAD_REL = 2.0 ** -6
#: bf16 losses and norm: the f32 sums over bf16 logits in another order
BF16_LOSS_REL = 1e-3
#: bf16 after two AdamW steps: moments within chip_smoke.py's training
#: tolerance (mu 2^-5, nu 2^-4 of each leaf's largest entry); parameters
#: within 2 lr a step plus a bf16 step of their size
BF16_MOMENT_REL = {"mu": 2.0 ** -5, "nu": 2.0 ** -4}
#: the sharded port against the unsharded port (f32, lossless capacity,
#: the load-balance term out of the loss: its per-shard form differs by
#: design): nll and every gradient
UNSHARDED_REL = 1e-6
#: ... with an absolute floor for a gradient that is zero in exact
#: arithmetic: Llama-4 routes top-1, so its renormalised gate weight is 1
#: whatever the router says, and without the load-balance term its
#: router's gradient is f32 noise (about 1e-10) on both sides
UNSHARDED_ATOL = 1e-8
#: f32 moments after the second step (tests/test_torch_train.py's bound
#: for yi-6b's; see ``test_sharded_train_steps_match_jax``)
MOMENT2_REL = 1e-4
TIMEOUT_S = 300


def _configs(arch):
    """(JAX config, port config), reduced; Llama-4 at 4 layers with its
    interleaving put back (``reduced()`` sets ``layer_period`` 1)."""
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    changes = {}
    if arch == LLAMA4:
        changes = dict(num_layers=4, moe=dataclasses.replace(
            get_config(arch).reduced().moe, layer_period=2))
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(t_get_config(arch).reduced(), **changes))


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    out = dict(
        tokens=rng.integers(0, cfg.vocab_size, size=(b, SEQ)).astype(np.int32),
        labels=rng.integers(0, cfg.vocab_size, size=(b, SEQ)).astype(np.int32),
        positions=np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                  (b, SEQ)).copy())
    out["labels"][0, :3] = -1
    out["labels"][-1, -2:] = -1
    return out


#: the collectives alone: name -> (mesh shape, axis, case)
COLLECTIVES = {
    "psum-2": ((2, 2), "model", "sum_over"),
    "psum-4": ((4, 1), "data", "sum_over"),
    "identity-psum-2": ((2, 2), "model", "sum_grad_over"),
    "identity-psum-4": ((4, 1), "data", "sum_grad_over"),
    "all_gather-2": ((2, 2), "model", "gather_over"),
    "all_gather-4": ((4, 1), "data", "gather_over"),
    "psum_scatter-2": ((2, 2), "model", "reduce_scatter"),
    "psum_scatter-4": ((4, 1), "data", "reduce_scatter"),
}


def _collective_inputs(seed=3):
    """Each rank's operands (row r of each), x (4, 8, 12) and y (4, 12,
    8), and cotangents of its outputs, cut from the largest shape any
    case's outputs take."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return dict(x=f(4, 8, 12), y=f(4, 12, 8), ct_x=f(4, 32, 12),
                ct_y=f(4, 12, 32))


def _checkpoint_inputs(path, jp):
    """A JAX checkpoint of reduced yi-6b's bf16 weights and random f32
    moments at step 3, for the port's ranks to restore re-sharded."""
    import jax
    import jax.numpy as jnp

    from repro.train import checkpoint as JC
    from repro.train import optim as JO
    rng = np.random.default_rng(11)

    def mom(a):
        return jnp.asarray(rng.normal(size=a.shape).astype(np.float32))

    opt = JO.AdamWState(jnp.asarray(3, jnp.int32), jax.tree.map(mom, jp),
                        jax.tree.map(mom, jp))
    JC.save_checkpoint(path, jp, opt, 3)


def _build_inputs(path, ckpt_path):
    import jax

    from repro.models import model as JM

    flat = {}
    for arch in dict.fromkeys(a for a, *_ in CASES.values()):
        cfg, _ = _configs(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), cfg)
        flat.update(_flatten(jax.tree.map(_bits, jp), f"{arch}/params/"))
        if arch == "yi-6b":
            _checkpoint_inputs(ckpt_path, jp)
    for i, (case, (arch, _, _, b)) in enumerate(CASES.items()):
        cfg, _ = _configs(arch)
        for step in range(2):
            for k, v in _batch(cfg, b, 100 + 10 * i + step).items():
                flat[f"{case}/batch{step}/{k}"] = v
    flat.update({f"coll/{k}": v for k, v in _collective_inputs().items()})
    np.savez(path, **flat)


def _case_batch(inp, case, step):
    return {k: inp[f"{case}/batch{step}/{k}"]
            for k in ("tokens", "labels", "positions")}


# ---------------------------------------------------------------------------
# the JAX reference (this file run as a script, in its own process)
# ---------------------------------------------------------------------------


def _jax_collectives(inp, out):
    """``jax.vjp`` of each collective case's ``shard_map``, the operands
    laid out globally (rank r's block r along dim 0, or block i along the
    other axis where the operand is replicated over the case's axis)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.models.sharding import shard_map

    c = {k[len("coll/"):]: v for k, v in inp.items() if k.startswith("coll/")}
    cat = lambda parts: np.concatenate(list(parts), axis=0)   # noqa: E731
    for name, (shape, ax, kind) in COLLECTIVES.items():
        mesh = jax.make_mesh(shape, AXES,
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        other = AXES[1 - AXES.index(ax)]
        n, k = shape[AXES.index(ax)], shape[AXES.index(other)]
        every = P(AXES)
        args = (cat(c["x"]), cat(c["y"]))
        if kind == "sum_over":
            fn = lambda x, y: (jax.lax.psum(x, ax),               # noqa: E731
                               jax.lax.psum(y, ax))
            specs = ((every, every), (P(other), P(other)))
            cts = (cat(c["ct_x"][:k, :8]), cat(c["ct_y"][:k, :, :8]))
        elif kind == "sum_grad_over":
            fn = lambda x, y: (x, y)                              # noqa: E731
            specs = ((P(other), P(other)), (every, every))
            args = (cat(c["x"][:k]), cat(c["y"][:k]))
            cts = (cat(c["ct_x"][:, :8]), cat(c["ct_y"][:, :, :8]))
        elif kind == "gather_over":
            fn = lambda x, y: (                                   # noqa: E731
                jax.lax.all_gather(x, ax, axis=0, tiled=True),
                jax.lax.all_gather(y, ax, axis=1, tiled=True))
            specs = ((every, every), (every, every))
            cts = (cat(c["ct_x"][:, :8 * n]), cat(c["ct_y"][:, :, :8 * n]))
        else:
            fn = lambda x, y: (                                   # noqa: E731
                jax.lax.psum_scatter(x, ax, scatter_dimension=0, tiled=True),
                jax.lax.psum_scatter(y, ax, scatter_dimension=1, tiled=True))
            specs = ((every, every), (every, every))
            cts = (cat(c["ct_x"][:, :8 // n]), cat(c["ct_y"][:, :, :8 // n]))
        f = shard_map(fn, mesh=mesh, in_specs=specs[0], out_specs=specs[1],
                      check_vma=False)
        _, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in args))
        gx, gy = vjp(tuple(jnp.asarray(ct) for ct in cts))
        out[f"coll/{name}/gx"] = np.asarray(gx)
        out[f"coll/{name}/gy"] = np.asarray(gy)


def _record_routes(JMOE, store):
    """Patch JAX's router to hand each call's ids and log-probabilities,
    with the calling device's (data, model) coordinates, to ``store``
    (a device's calls arrive in its program's order: the pass's layers,
    then the recompute's in reverse).  Returns the original."""
    import jax

    orig = JMOE.router_topk

    def topk(logits, top_k):
        weights, ids, probs = orig(logits, top_k)

        def keep(i, j, ids, probs):
            store.setdefault((int(i), int(j)), []).append(
                (np.asarray(ids), np.log(np.asarray(probs))))

        jax.debug.callback(keep, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"), ids, probs)
        return weights, ids, probs

    JMOE.router_topk = topk
    return orig


def _jax_reference(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.launch.mesh import make_rules
    from repro.models import model as JM
    from repro.models import moe as JMOE
    from repro.train import optim as JO

    inp = dict(np.load(inputs_path))
    out = {}
    _jax_collectives(inp, out)
    for case, (arch, dtype, shape, _) in CASES.items():
        cfg, _ = _configs(arch)
        params = jax.tree.map(
            lambda a: jnp.asarray(a.view(ml_dtypes.bfloat16)
                                  if a.dtype == np.uint16 else a),
            _unflatten(inp, f"{arch}/params/"))
        if dtype == "float32":      # the same weights widened (exact)
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        mesh = jax.make_mesh(shape, AXES,
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = make_rules(mesh)
        routes = {}
        if case in REPLAYED:
            orig = _record_routes(JMOE, routes)
        batches = [{k: jnp.asarray(v) for k, v in
                    _case_batch(inp, case, s).items()} for s in range(2)]
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, b, cfg, rules), has_aux=True))(
                params, batches[0])
        out.update({f"{case}/grads/{k}": np.asarray(v, np.float32)
                    for k, v in _flatten(grads, "").items()})
        step = jax.jit(lambda p, o, b: JO.train_step(p, o, b, cfg, rules,
                                                     lr=LR))
        opt = JO.adamw_init(params)
        for s in range(2):
            params, opt, m = step(params, opt, batches[s])
            for k, v in m.items():
                out[f"{case}/step{s}/{k}"] = np.asarray(v)
            for name, tree in (("mu", opt.mu), ("nu", opt.nu)):
                out.update({f"{case}/step{s}/{name}/{k}":
                            np.asarray(v, np.float32)
                            for k, v in _flatten(tree, "").items()})
        out.update({f"{case}/params/{k}": np.asarray(v, np.float32)
                    for k, v in _flatten(params, "").items()})
        out[f"{case}/metrics"] = np.asarray(
            [float(metrics["nll"]), float(metrics["aux"])])
        if case in REPLAYED:
            jax.effects_barrier()
            JMOE.router_topk = orig
            for (i, j), calls in routes.items():
                r = i * shape[1] + j
                out[f"{case}/routes/{r}/ids"] = np.stack([c[0] for c in calls])
                out[f"{case}/routes/{r}/logp"] = np.stack([c[1]
                                                           for c in calls])
    np.savez(out_path, **out)


class _Replay:
    """Inside ``with``: the port's router takes, call by call, the ids
    that JAX's router gave on this rank's device (its gate weights
    gathered from the port's own probabilities, as ``router_topk``
    renormalises them), and records each row whose own top-k differs:
    (call, row, the port's gap log p_k / p_(k+1), JAX's gap, the row's
    largest |log p| difference between the two)."""

    def __init__(self, TMOE, ids, logp):
        self.TMOE, self.ids, self.logp = TMOE, ids, logp
        self.calls, self.differ = 0, []

    def __enter__(self):
        self.orig = self.TMOE.router_topk
        self.TMOE.router_topk = self.topk
        return self

    def __exit__(self, *exc):
        self.TMOE.router_topk = self.orig

    def topk(self, logits, top_k):
        weights, ids, probs = self.orig(logits, top_k)
        want = torch.from_numpy(self.ids[self.calls]).to(ids.dtype)
        jl = torch.from_numpy(self.logp[self.calls])
        tl = torch.log(probs.detach())
        rows = (ids.sort(-1).values != want.sort(-1).values).any(-1)
        for r in rows.nonzero().flatten().tolist():
            gap = [float(x[top_k - 1] - x[top_k]) for x in (
                tl[r].sort(descending=True).values,
                jl[r].sort(descending=True).values)]
            self.differ.append((self.calls, r, *gap,
                                float((tl[r] - jl[r]).abs().max())))
        self.calls += 1
        weights = probs.gather(1, want.long())
        return (weights / torch.clamp(weights.sum(-1, keepdim=True),
                                      min=1e-9), want, probs)


# ---------------------------------------------------------------------------
# the port (4 gloo ranks)
# ---------------------------------------------------------------------------


def _port_collectives(inp, meshes):
    """This rank's gradients of each collective case, as JAX's layout
    holds them (its block of the operand's cotangent)."""
    from repro_torch.core import collectives as C
    c = {k[len("coll/"):]: v for k, v in inp.items() if k.startswith("coll/")}
    out = {}
    for name, (shape, ax, kind) in COLLECTIVES.items():
        rules = meshes[shape]
        mesh = rules.mesh
        r = mesh.rank
        other = AXES[1 - AXES.index(ax)]
        n, io = mesh.axis_size(ax), mesh.axis_index(other)
        group = mesh.group(ax)
        if kind == "sum_grad_over":
            x, y = c["x"][io], c["y"][io]
        else:
            x, y = c["x"][r], c["y"][r]
        x, y = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, y))
        if kind == "sum_over":
            outs = (C.sum_over(x, group), C.sum_over(y, group))
            cts = (c["ct_x"][io, :8], c["ct_y"][io, :, :8])
        elif kind == "sum_grad_over":
            outs = (C.sum_grad_over(x, group), C.sum_grad_over(y, group))
            cts = (c["ct_x"][r, :8], c["ct_y"][r, :, :8])
        elif kind == "gather_over":
            outs = C.gather_over([x, y], [0, 1], group)
            cts = (c["ct_x"][r, :8 * n], c["ct_y"][r, :, :8 * n])
        else:
            outs = C.reduce_scatter([x, y], [0, 1], group)
            cts = (c["ct_x"][r, :8 // n], c["ct_y"][r, :, :8 // n])
        gx, gy = torch.autograd.grad(outs, (x, y), [torch.from_numpy(
            ct.copy()) for ct in cts])
        out[f"coll/{name}"] = (gx.numpy(), gy.numpy())
    return out


def _sharded_grads(TM, O, params, batch, cfg, rules):
    """The rank's loss, metrics and gradients (summed and normed as
    ``train_step`` takes them), the gradients gathered whole."""
    from repro_torch.bridge import gather_train
    leaves = O.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = TM.loss_fn(params, batch, cfg, rules)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    specs = O._spec_leaves(TM.param_specs(cfg, rules))
    grads = O._sync_grads(grads, specs, rules)
    gnorm = O._sharded_norm(grads, specs, rules)
    full, _ = gather_train(O.tree_unflatten(params, grads), None, cfg, rules,
                           dst=None)
    return ({k: float(v.detach()) for k, v in metrics.items()}, float(gnorm),
            {k: v.float().numpy() for k, v in _flatten(full, "").items()})


def _whole_leaves(O, TM, params, cfg, rules):
    """The bits of every leaf that no mesh axis splits (each rank holds
    it whole), as one byte string for comparison across ranks."""
    specs = O._spec_leaves(TM.param_specs(cfg, rules))
    return b"".join(t.contiguous().view(torch.uint8).numpy().tobytes()
                    for t, spec in zip(O.tree_leaves(params), specs)
                    if not any(spec))


def _without_tensor_parallelism(rules):
    """``rules`` with tensor parallelism's logical axes mapped to no mesh
    axis: data parallelism, FSDP and expert parallelism alone."""
    return dataclasses.replace(rules, rules=dict(
        rules.rules, **dict.fromkeys(TENSOR_PARALLEL_AXES)))


def _port_case(case, inp, rules, rank, ckpt_out=None, tensor_parallel=False):
    """One case on this rank: the first step's loss and gradients, then
    two ``train_step(..., rules)`` calls; the gathered gradients,
    parameters and moments (rank 0), the whole leaves' bits after each
    step (every rank).  The mesh runs data parallelism, FSDP and expert
    parallelism, and tensor parallelism only where ``tensor_parallel``
    (the unsharded port's gradients are then left to the other run);
    yi-6b-bf16's checkpoint is written from the trees' tensor-parallel
    shards under ``rules``."""
    from repro_torch.bridge import gather_train, params_from_numpy, shard_train
    from repro_torch.models import model as TM
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import optim as O

    arch, dtype, _, _ = CASES[case]
    _, cfg = _configs(arch)
    tp_rules = rules
    if not tensor_parallel:
        rules = _without_tensor_parallelism(rules)
    full = params_from_numpy(_unflatten(inp, f"{arch}/params/"), cfg, "cpu")
    if dtype == "float32":      # the same weights widened (exact)
        full = _unflatten({k: v.float() for k, v in
                           _flatten(full, "").items()}, "")
    batches = [{k: torch.from_numpy(v) for k, v in
                _case_batch(inp, case, s).items()} for s in range(2)]
    p, _ = shard_train(full, None, cfg, rules)
    res = {}
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
    if case == "yi-6b-bf16" and not tensor_parallel:
        # written from the tensor-parallel shards of the same trees
        whole_p, whole_o = gather_train(p, opt, cfg, rules, dst=None)
        tp_p, tp_o = shard_train(whole_p, whole_o, cfg, tp_rules)
        TC.save_checkpoint(ckpt_out, tp_p, tp_o, 2, cfg=cfg, rules=tp_rules)
    pf, _ = gather_train(p, None, cfg, rules)
    if rank == 0:
        res["params"] = {k: v.float().numpy()
                         for k, v in _flatten(pf, "").items()}
        if case == "yi-6b-bf16":
            res["bits"] = {k: v.contiguous().view(torch.uint8).numpy()
                           for k, v in _flatten(pf, "params/").items()}
    if case in UNSHARDED:
        # the load-balance term out of the loss: sharded against the
        # unsharded port, nll and every gradient
        flat = dataclasses.replace(cfg, moe=None if cfg.moe is None else
                                   dataclasses.replace(cfg.moe,
                                                       lb_loss_weight=0.0))
        ps, _ = shard_train(full, None, flat, rules)
        res["lossless"] = _sharded_grads(TM, O, ps, batches[0], flat, rules)
        if rank == 0 and not tensor_parallel:
            res["unsharded"] = _unsharded_grads(TM, O, full, batches[0],
                                                flat)
    return res


def _port_replayed(rank, world, inputs_path, jax_path):
    """The cases of ``REPLAYED`` on this rank, under JAX's routing of the
    same device (``_Replay``), without tensor parallelism and (those of
    ``TP_CASES``) with it."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import moe as TMOE

    inp, ref = dict(np.load(inputs_path)), np.load(jax_path)
    out = {}
    for case in REPLAYED:
        rules = make_rules(Mesh(CASES[case][2], AXES))
        for key, tp in ((case, False), (f"tp/{case}", True)):
            if tp and case not in TP_CASES:
                continue
            with _Replay(TMOE, ref[f"{case}/routes/{rank}/ids"],
                         ref[f"{case}/routes/{rank}/logp"]) as replay:
                out[key] = _port_case(case, inp, rules, rank,
                                      tensor_parallel=tp)
            out[key]["ties"] = replay.differ
            out[key]["router_calls"] = replay.calls
    return out


def _port_ranks(rank, world, inputs_path, ckpt_in, ckpt_out, loop_dir):
    """Every case but ``REPLAYED``'s, the collectives, ``init_params`` on a
    rank, a JAX checkpoint restored re-sharded and the loop."""
    torch.set_num_threads(1)
    from repro_torch.bridge import shard_train
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMOE
    from repro_torch.models import params as TP
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import optim as O
    from repro_torch.train.loop import train

    inp = dict(np.load(inputs_path))
    meshes = {shape: make_rules(Mesh(shape, AXES))
              for shape in dict.fromkeys(s for _, _, s, _ in CASES.values())}
    out = {"coords": meshes[(2, 2)].mesh.coords}
    out.update(_port_collectives(inp, meshes))

    # the MoE layer under grad never indexes the rows through autograd
    indexed = []
    plain_gather = TMOE._gather_slots

    def gather_slots(rows, slot_token):
        indexed.append(torch.is_grad_enabled() and rows.requires_grad)
        return plain_gather(rows, slot_token)

    TMOE._gather_slots = gather_slots
    for case in CASES:
        if case not in REPLAYED:
            out[case] = _port_case(case, inp, meshes[CASES[case][2]], rank,
                                   ckpt_out)
    for case in TP_CASES:
        if case not in REPLAYED:
            out[f"tp/{case}"] = _port_case(case, inp, meshes[CASES[case][2]],
                                           rank, tensor_parallel=True)
    TMOE._gather_slots = plain_gather
    out["indexed_under_grad"] = sum(indexed)
    out["gathered_slots"] = len(indexed)

    # init_params on a rank: its block of the unsharded draw
    _, cfg = _configs("phi-tiny-moe")
    rules = meshes[(2, 2)]
    mine = TP.init_params(cfg, torch.Generator().manual_seed(5), "cpu",
                          rules=rules)
    whole_tree = TP.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    whole, _ = shard_train(whole_tree, None, cfg, rules)
    out["init_equal"] = all(torch.equal(a, b) for a, b in zip(
        O.tree_leaves(mine), O.tree_leaves(whole)))
    out["init_shapes"] = {k: tuple(v.shape) for k, v in
                          _flatten(mine, "").items()}

    # gather_train: the whole trees on rank 0 alone, moved in pieces of
    # one layer's expert shard at most
    out.update(_gather_in_pieces(mine, whole_tree, cfg, rules))

    # a JAX checkpoint restored re-sharded
    _, cfg = _configs("yi-6b")
    tmpl = TP.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                          rules=rules)
    params, opt, step = TC.restore_checkpoint(ckpt_in, tmpl,
                                              O.adamw_init(tmpl), cfg=cfg,
                                              rules=rules)
    out["restored"] = (step, int(opt.step), {
        k: v.contiguous().view(torch.uint8).numpy() for k, v in
        _flatten({"params": params, "mu": opt.mu, "nu": opt.nu}, "").items()})

    # the loop: two steps on the mesh, rank 0 printing, a final checkpoint
    _, cfg = _configs("phi-tiny-moe")
    _, _, hist = train(cfg, steps=2, batch=4, seq_len=SEQ, lr=LR, seed=2,
                       rules=rules, ckpt_dir=loop_dir, log_every=1,
                       device="cpu")
    out["loop"] = [{k: v for k, v in h.items() if k != "tok_s"}
                   for h in hist]
    return out


def _gather_in_pieces(shards, whole, cfg, rules):
    """``gather_train`` of a rank's ``shards`` of the parameters ``whole``
    and moments made from them, its piece set to one layer of the rank's
    expert shard: (whether this rank's result is the whole trees, bit for
    bit, on the host (rank 0) or (None, None) (the others); the bytes of
    the largest gathered piece; the largest leaf's; the pieces)."""
    from repro_torch import bridge as B
    from repro_torch.core import collectives as C
    from repro_torch.train import optim as O

    leaves = O.tree_leaves(shards)
    opt = O.adamw_init(shards)._replace(
        mu=O.tree_unflatten(shards, [t.float() * 0.5 for t in leaves]),
        nu=O.tree_unflatten(shards, [t.float() ** 2 for t in leaves]))
    sizes, plain, piece = [], C.all_gather, B.GATHER_PIECE_BYTES

    def all_gather(t, group, order):
        got = plain(t, group, order)
        sizes.append(got.numel() * got.element_size())
        return got

    C.all_gather = all_gather
    B.GATHER_PIECE_BYTES = shards["layers"]["moe"]["wi"][0].numel() * 4
    try:
        p, o = B.gather_train(shards, opt, cfg, rules)
    finally:
        C.all_gather, B.GATHER_PIECE_BYTES = plain, piece
    if rules.mesh.rank == 0:
        ok = all(t.device.type == "cpu" and torch.equal(t, w)
                 for t, w in zip(O.tree_leaves(p), O.tree_leaves(whole)))
        ok &= all(torch.equal(t, w.float() * 0.5) for t, w in zip(
            O.tree_leaves(o.mu), O.tree_leaves(whole)))
        ok &= all(torch.equal(t, w.float() ** 2) for t, w in zip(
            O.tree_leaves(o.nu), O.tree_leaves(whole)))
    else:
        ok = p is None and o is None
    largest = max(t.numel() * 4 for t in O.tree_leaves(whole))
    return {"gather_ok": ok, "gather_piece": max(sizes),
            "gather_largest_leaf": largest, "gather_pieces": len(sizes)}


def _unsharded_grads(TM, O, params, batch, cfg):
    leaves = O.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = TM.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            float(O._global_norm(O.tree_unflatten(params, list(grads)))),
            {k: v.float().numpy() for k, v in _flatten(
                O.tree_unflatten(params, list(grads)), "").items()})


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each port rank's results, the paths written)."""
    from repro_torch.launch.mesh import launch

    tmp = tmp_path_factory.mktemp("sharded_train")
    inputs, jax_out = tmp / "inputs.npz", tmp / "jax.npz"
    paths = dict(ckpt_in=tmp / "jax_ckpt.npz", ckpt_out=tmp / "port_ckpt.npz",
                 loop=tmp / "loop")
    _build_inputs(inputs, paths["ckpt_in"])
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, __file__, "--jax-reference", str(inputs),
         str(jax_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch(_port_ranks, 4, (str(inputs), str(paths["ckpt_in"]),
                                        str(paths["ckpt_out"]),
                                        str(paths["loop"])),
                       timeout=TIMEOUT_S)
    finally:
        log, _ = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, log[-4000:]
    # the replayed cases need JAX's routing first
    for r, more in zip(ranks, launch(_port_replayed, 4, (
            str(inputs), str(jax_out)), timeout=TIMEOUT_S)):
        r.update(more)
    return dict(np.load(jax_out)), ranks, paths


def test_ranks_are_the_mesh(runs):
    _, ranks, _ = runs
    assert [r["coords"] for r in ranks] == [
        {"data": i, "model": j} for i in range(2) for j in range(2)]


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_gradients_match_jax_transposes(runs, name):
    """Each differentiable collective's gradient against ``jax.vjp`` of the
    same ``shard_map`` (``psum`` into an output replicated over the axis;
    an input replicated over it; ``all_gather(tiled=True)`` along dims 0
    and 1 in one call; ``psum_scatter(tiled=True)`` likewise) over 2 and 4
    ranks: each rank's gradient is its block of JAX's."""
    ref, ranks, _ = runs
    shape, ax, kind = COLLECTIVES[name]
    gx_all, gy_all = ref[f"coll/{name}/gx"], ref[f"coll/{name}/gy"]
    for rank, r in enumerate(ranks):
        gx, gy = r[f"coll/{name}"]
        if kind == "sum_grad_over":
            # the operand is one block per index along the other axis
            other = AXES[1 - AXES.index(ax)]
            io = r["coords"][other] if shape == (2, 2) else 0
            wx, wy = gx_all[io * 8:(io + 1) * 8], gy_all[io * 12:(io + 1) * 12]
        else:
            wx = gx_all[rank * 8:(rank + 1) * 8]
            wy = gy_all[rank * 12:(rank + 1) * 12]
        np.testing.assert_allclose(gx, wx, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gy, wy, rtol=1e-6, atol=1e-6)


def test_plain_collectives_refuse_a_gradient():
    """``all_reduce`` and ``all_gather`` called in grad mode on a tensor
    that requires grad raise (their result would cut the gradient), and
    say which collectives carry it; under ``no_grad`` they are not
    refused (no process group here: the refusal comes first)."""
    from repro_torch.core import collectives as C
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="all_reduce: a plain collective "
                       "cuts the gradient"):
        C.all_reduce(t, "sum", None)
    with pytest.raises(RuntimeError, match="all_gather: .*gather_over"):
        C.all_gather(t * 2, None, [0])
    with torch.no_grad(), pytest.raises(ValueError, match="process group"):
        C.all_reduce(t, "sum", None)


def test_moe_layer_under_grad_does_not_index_through_autograd(runs):
    """``_expert_parallel`` under grad gathers its dispatch rows through
    ``_DispatchGather`` (whose forward runs outside grad mode), never by
    autograd's indexing, whose backward one warp per token would run."""
    _, ranks, _ = runs
    for r in ranks:
        assert r["gathered_slots"] > 0
        assert r["indexed_under_grad"] == 0


def _hold_tree(got, want, rel, what, atol=0.0):
    """Each leaf within ``rel`` of its largest entry (plus ``atol``)."""
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        err = np.abs(got[k] - want[k]).max()
        assert err <= rel * np.abs(want[k]).max() + atol, (what, k, err)


def _check_gradients(runs, case, key, bf16_grad_rel):
    """The port's run ``key`` of ``case``: the first step's nll, aux and
    every gradient against JAX's; every rank the same gradients."""
    ref, ranks, _ = runs
    dtype = CASES[case][1]
    r0 = ranks[0][key]
    want = {k[len(case) + 7:]: v for k, v in ref.items()
            if k.startswith(f"{case}/grads/")}
    rel = F32_REL if dtype == "float32" else bf16_grad_rel
    _hold_tree(r0["grads"], want, rel, "grads")
    nll, aux = ref[f"{case}/metrics"]
    tol = F32_REL if dtype == "float32" else BF16_LOSS_REL
    np.testing.assert_allclose(r0["metrics"]["nll"], nll, rtol=tol)
    np.testing.assert_allclose(r0["metrics"]["aux"], aux, rtol=tol, atol=1e-7)
    for r in ranks[1:]:
        for k, g in r[key]["grads"].items():
            assert np.array_equal(g, r0["grads"][k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gradients_match_jax(runs, case):
    """The first step's nll, aux and every gradient (gathered whole)
    against ``jax.value_and_grad`` of JAX's ``loss_fn`` under the same
    mesh's rules; every rank gathers the same gradients."""
    _check_gradients(runs, case, case, BF16_GRAD_REL)


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_gradients_match_jax(runs, case):
    """The same, tensor-parallel over ``model`` (the default rules): bf16
    gradients within ``TP_BF16_GRAD_REL``."""
    _check_gradients(runs, case, f"tp/{case}", TP_BF16_GRAD_REL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_steps_match_jax(runs, case):
    """Two ``train_step(..., rules)`` calls against JAX's jitted
    ``train_step`` on the same mesh: each step's loss, nll, aux and
    grad_norm, ``mu`` and ``nu`` after each step, and every parameter
    after the second, all gathered whole.  Every rank reports the same
    metrics and holds the same bits of every leaf that no axis splits,
    after each step.

    f32: the first step's moments within ``F32_REL`` of each leaf's
    largest entry (the same parameters on both sides).  AdamW moves a
    parameter by about +-lr whatever |g| while |g| >> eps, so where a
    gradient entry sits within the two frameworks' f32 noise of 0 its
    update is decided by that noise, and the second step's gradients
    follow the moved parameters: its moments are held to ``MOMENT2_REL``
    and the parameters as tests/test_torch_train.py holds three steps
    (every one within 2 lr a step, all but 1e-4 of them within 2e-6).
    bf16: ``BF16_LOSS_REL``, ``BF16_MOMENT_REL`` and each parameter
    within 2 lr a step plus a bf16 step of its size."""
    _check_steps(runs, case, case, BF16_LOSS_REL)


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_train_steps_match_jax(runs, case):
    """The same, tensor-parallel over ``model`` (the default rules): the
    bf16 gradient norm within ``TP_BF16_GNORM_REL``."""
    _check_steps(runs, case, f"tp/{case}", TP_BF16_GNORM_REL)


def _check_steps(runs, case, key, bf16_gnorm_rel):
    """The port's run ``key`` of ``case``: two steps against JAX's
    (``test_sharded_train_steps_match_jax``)."""
    ref, ranks, _ = runs
    dtype = CASES[case][1]
    r0 = ranks[0][key]
    f32 = dtype == "float32"
    for s in range(2):
        for k in ("loss", "nll", "aux", "grad_norm"):
            tol = F32_REL if f32 else (bf16_gnorm_rel if k == "grad_norm"
                                       else BF16_LOSS_REL)
            np.testing.assert_allclose(
                r0["steps"][s][k], float(ref[f"{case}/step{s}/{k}"]),
                rtol=tol, atol=1e-7, err_msg=f"step {s} {k}")
    for r in ranks[1:]:
        assert r[key]["steps"] == r0["steps"]
        assert r[key]["whole"] == r0["whole"]
    for s in range(2):
        for name in ("mu", "nu"):
            pre = f"{case}/step{s}/{name}/"
            want = {k[len(pre):]: v for k, v in ref.items()
                    if k.startswith(pre)}
            rel = (F32_REL if s == 0 else MOMENT2_REL) if f32 else \
                BF16_MOMENT_REL[name]
            _hold_tree(r0[f"step{s}/{name}"], want, rel, f"step {s} {name}")
    want = {k[len(case) + 8:]: v for k, v in ref.items()
            if k.startswith(f"{case}/params/")}
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
    assert off <= 1e-4 * total, (off, total)


def test_bf16_router_ties_are_named(runs):
    """Where JAX's sharded bf16 router chose other experts than the
    port's own on the same device (the port's runs replay JAX's choice):
    each such row is named in ``KNOWN_ROUTER_TIES``, and each is a near
    tie that the two runs' roundings explain (the two gaps between the
    k-th and (k + 1)-th log-probability sum to no more than twice the
    row's largest log-probability difference between the runs)."""
    _check_ties(runs, "", KNOWN_ROUTER_TIES)


@pytest.mark.parametrize("case", [c for c in REPLAYED if c in TP_CASES])
def test_tensor_parallel_bf16_router_ties_are_named(runs, case):
    """The same for the replayed runs tensor-parallel over ``model``: each
    row routed otherwise is named in ``KNOWN_TP_ROUTER_TIES`` and is a
    near tie."""
    _check_ties(runs, "tp/", KNOWN_TP_ROUTER_TIES, (case,))


def _check_ties(runs, prefix, known, cases=REPLAYED):
    _, ranks, _ = runs
    for case in cases:
        for rank, r in enumerate(ranks):
            res = r[prefix + case]
            assert res["router_calls"] == 12      # 3 passes x 4 calls
            got = sorted((c, row) for c, row, *_ in res["ties"])
            assert got == sorted(known.get((case, rank), [])), \
                (case, rank, res["ties"])
            for _, _, gap_port, gap_jax, moved in res["ties"]:
                assert gap_port + gap_jax <= 2 * moved, res["ties"]


@pytest.mark.parametrize("case", UNSHARDED)
def test_sharded_matches_unsharded_port(runs, case):
    """At the reduced configs' lossless capacity (factor 8.0) and without
    the load-balance term in the loss, the sharded pass is the unsharded
    pass: nll and every gradient within ``UNSHARDED_REL`` (f32), the norm
    too.  The load-balance loss itself differs by design (each data
    shard's over its own rows, JAX's ``aux[None] / dsize``) where the
    batch is split."""
    _, ranks, _ = runs
    r0 = ranks[0][case]
    (m, gnorm, grads), (um, ugnorm, ugrads) = r0["lossless"], r0["unsharded"]
    np.testing.assert_allclose(m["nll"], um["nll"], rtol=UNSHARDED_REL)
    np.testing.assert_allclose(gnorm, ugnorm, rtol=UNSHARDED_REL)
    _hold_tree(grads, ugrads, UNSHARDED_REL, "grads", atol=UNSHARDED_ATOL)
    arch, _, shape, b = CASES[case]
    if arch != "yi-6b" and b % shape[0] == 0 and shape[0] > 1:
        assert m["aux"] != um["aux"]


@pytest.mark.parametrize("case", [c for c in TP_CASES if c in UNSHARDED])
def test_tensor_parallel_matches_unsharded_port(runs, case):
    """The same, tensor-parallel over ``model``: nll, the norm and every
    gradient within ``TP_UNSHARDED_REL``."""
    _, ranks, _ = runs
    r0 = ranks[0]
    (m, gnorm, grads) = r0[f"tp/{case}"]["lossless"]
    um, ugnorm, ugrads = r0[case]["unsharded"]
    np.testing.assert_allclose(m["nll"], um["nll"], rtol=TP_UNSHARDED_REL)
    np.testing.assert_allclose(gnorm, ugnorm, rtol=TP_UNSHARDED_REL)
    _hold_tree(grads, ugrads, TP_UNSHARDED_REL, "grads", atol=UNSHARDED_ATOL)


#: one config of every family the schema covers, at full size (schemas
#: only: nothing is allocated)
SCHEMA_ARCHS = ["yi-6b", "command-r-35b", "qwen2-vl-72b", "qwen2-moe",
                LLAMA4, "zamba2-7b", "xlstm-1.3b", "musicgen-medium",
                "phi-tiny-moe"]


@pytest.mark.parametrize("arch", SCHEMA_ARCHS)
def test_schema_axes_match_jax(arch):
    """Every leaf of the port's schema names the logical axes of the JAX
    package's ``ParamDef``, and ``param_specs`` on the production mesh
    keeps JAX's ``param_specs`` of the dims it splits (``TRAIN_SPLITS``:
    ``embed_fsdp``, ``experts``, ``heads``, ``kv_heads``, ``ff``,
    ``vocab``; a recurrent layer's leaf ``RECURRENT_SPLITS``, its ``ff``
    and ``state_heads`` over ``model`` only where the layer's heads divide
    the axis, and sLSTM's MLP where its hidden width does too) and leaves
    every other dim whole; a model with attention or an MLP splits some
    leaf over ``model``; Mamba2's ``in_proj`` and conv leaves split as
    segments (the rank's heads' channels, B and C whole)."""
    from jax.sharding import AbstractMesh, AxisType

    from repro.configs import get_config
    from repro.launch import mesh as jmesh
    from repro.models import params as JP
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import params as TP

    changes = {}
    if arch == LLAMA4:
        changes = dict(moe=dataclasses.replace(get_config(arch).moe,
                                               layer_period=2))
    cfg = dataclasses.replace(get_config(arch), **changes)
    tcfg = dataclasses.replace(t_get_config(arch), **changes)
    jschema = _flatten(JP.build_schema(cfg), "")
    tschema = _flatten(TP.build_schema(tcfg), "")
    assert jschema.keys() == tschema.keys()
    for k, j in jschema.items():
        assert tschema[k].axes == j.axes and tschema[k].shape == j.shape, k
    jrules = jmesh.make_rules(AbstractMesh((16, 16), AXES, axis_types=(
        AxisType.Auto,) * 2))
    trules = tmesh.make_rules(tmesh.Mesh((16, 16), AXES))
    jspecs = _flatten(JP.param_specs(cfg, jrules), "")
    tspecs = _flatten(TP.param_specs(tcfg, trules), "")
    from repro_torch.models.sharding import (RECURRENT_SPLITS, TRAIN_SPLITS,
                                             Segments)
    split = over_model = 0
    for k, j in jspecs.items():
        j = tuple(j) + (None,) * (len(tschema[k].shape) - len(tuple(j)))
        recurrent = k.startswith(("supers/", "mamba_layers/mamba/"))
        names = RECURRENT_SPLITS if recurrent else TRAIN_SPLITS
        if recurrent and not _recurrent_heads_divide(tcfg, k, 16):
            names = ("embed_fsdp",)
        want = tuple(ax if name in names else None
                     for ax, name in zip(j, jschema[k].axes))
        assert tspecs[k] == want, (k, tspecs[k], j)
        segmented = k.endswith(("/in_proj", "/conv_w", "/conv_b")) \
            and k.startswith("mamba_layers/")
        assert any(isinstance(ax, Segments) for ax in tspecs[k]) \
            == (segmented and "model" in want), k
        split += any(want)
        over_model += "model" in want
    assert split > 0 and over_model > 0


def _recurrent_heads_divide(cfg, key, n):
    """The recurrent layer of the leaf ``key`` splits over ``n`` ranks of
    ``model``: its heads divide them (Mamba2's d_inner / head_dim, the
    xLSTM blocks' ``num_heads``), and for sLSTM's MLP its hidden width
    too."""
    if key.startswith("mamba_layers/"):
        heads = [cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim]
    else:
        heads = [cfg.num_heads]
        if "/mlp_" in key:
            heads.append(int(cfg.d_model * cfg.xlstm.proj_factor_slstm))
    return all(h % n == 0 for h in heads)


def test_init_params_on_a_rank_is_its_block(runs):
    """``init_params(..., rules)`` keeps the rank's block of the very
    draws the unsharded call makes: experts, q heads and the vocabulary
    over ``model`` (reduced phi-tiny-moe's one kv head stays whole),
    d_model over ``data``."""
    _, ranks, _ = runs
    assert all(r["init_equal"] for r in ranks)
    shapes = ranks[0]["init_shapes"]
    assert shapes["layers/moe/wi"] == (2, 2, 128, 256)
    assert shapes["layers/moe/wo"] == (2, 2, 256, 128)
    assert shapes["layers/attn/wq"] == (2, 128, 2, 64)
    assert shapes["layers/attn/wk"] == (2, 128, 1, 64)
    assert shapes["layers/attn/wo"] == (2, 2, 64, 128)
    assert shapes["embed"] == (256, 128)
    assert shapes["lm_head"] == (128, 256)
    assert shapes["layers/ln1"] == (2, 256)


def test_gather_train_moves_pieces_to_one_rank(runs):
    """``gather_train`` leaves the whole parameters and moments on rank
    0's host alone (the other ranks get None and keep nothing), moving
    each split leaf in pieces: no gathered piece is larger than a layer
    of an f32 expert leaf over the four ranks, less than the largest
    leaf, so no rank's device ever holds the whole trees."""
    _, ranks, _ = runs
    assert all(r["gather_ok"] for r in ranks)
    r0 = ranks[0]
    assert r0["gather_piece"] < r0["gather_largest_leaf"]
    assert r0["gather_pieces"] > len(ranks[0]["init_shapes"])


def test_sharded_checkpoint_restores_in_jax(runs):
    """A checkpoint the port's ranks wrote on the (2, 2) mesh (gathered,
    rank 0 writing) restores in ``repro.train.checkpoint`` into the
    unsharded templates, bit for bit the ranks' gathered parameters."""
    import jax

    from repro.models import model as JM
    from repro.train import checkpoint as JC
    from repro.train import optim as JO
    _, ranks, paths = runs
    cfg, _ = _configs("yi-6b")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    params, opt, step = JC.restore_checkpoint(paths["ckpt_out"], jp,
                                              JO.adamw_init(jp))
    assert step == 2 and int(opt.step) == 2
    r0 = ranks[0]["yi-6b-bf16"]
    bits = r0["bits"]
    for k, v in _flatten(jax.tree.map(np.asarray, params), "params/").items():
        assert np.array_equal(v.view(np.uint8).reshape(bits[k].shape),
                              bits[k]), k
    for name, tree in (("mu", opt.mu), ("nu", opt.nu)):
        for k, v in _flatten(jax.tree.map(np.asarray, tree), "").items():
            assert np.array_equal(v, r0[f"step1/{name}"][k]), (name, k)


def test_jax_checkpoint_restores_sharded(runs):
    """A JAX checkpoint (bf16 weights, f32 moments) restored on the mesh:
    each rank holds its block of every array, bit for bit."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import param_specs
    from repro_torch.models.sharding import (DEFAULT_RULES, ShardingRules,
                                             shard_slices)
    _, ranks, paths = runs
    _, cfg = _configs("yi-6b")
    data = np.load(paths["ckpt_in"])
    for rank, r in enumerate(ranks):
        step, opt_step, got = r["restored"]
        assert step == 3 and opt_step == 3
        rules = ShardingRules(Mesh((2, 2), AXES, rank=rank),
                              dict(DEFAULT_RULES))
        specs = _flatten(param_specs(cfg, rules), "")
        for key, v in got.items():
            kind, path = key.split("/", 1)
            name = {"params": "params/", "mu": "opt/mu/",
                    "nu": "opt/nu/"}[kind] + path
            arr = data[name] if name in data else data[name + "@bfloat16"]
            if any(specs[path]):
                arr = arr[shard_slices(rules, specs[path], arr.shape)]
            assert np.array_equal(np.ascontiguousarray(arr).view(np.uint8)
                                  .reshape(v.shape), v), key


def test_train_loop_on_a_mesh(runs):
    """``train(..., rules=rules)`` on the (2, 2) mesh: every rank the same
    history, the first step's nll the unsharded loop's (the same draws,
    the same global batch), and one unsharded final checkpoint."""
    from repro_torch.train.loop import train
    _, ranks, paths = runs
    hist = ranks[0]["loop"]
    assert all(r["loop"] == hist for r in ranks[1:])
    assert [h["step"] for h in hist] == [0, 1]
    _, cfg = _configs("phi-tiny-moe")
    _, _, ref = train(cfg, steps=2, batch=4, seq_len=SEQ, lr=LR, seed=2,
                      log_every=1, device="cpu")
    # bf16 weights: the sum over ``model`` rounds once where the
    # unsharded combine rounds add by add
    np.testing.assert_allclose(hist[0]["nll"], ref[0]["nll"],
                               rtol=BF16_LOSS_REL)
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert sorted(p.name for p in Path(paths["loop"]).glob("*.npz")) == \
        ["final.npz"]


def test_train_cli_mesh_pod_needs_its_world(monkeypatch):
    """``--mesh pod`` in a world of one rank stops at the production
    mesh: it needs 256 ranks."""
    from repro_torch.launch import train as launch
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs 256 ranks; the world "
                       "has 1"):
        launch.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                     "--mesh", "pod", "--steps", "1"])


def test_train_cli_mesh_none_trains_on_the_cpu(capsys, tmp_path):
    """``--mesh none --device cpu`` trains a reduced model on one device,
    as before, and logs each step."""
    from repro_torch.launch import train as launch
    launch.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                 "--mesh", "none", "--steps", "2", "--batch", "2",
                 "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2 and "loss" in lines[0]
    assert (tmp_path / "final.npz").exists()


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-reference"]:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    _jax_reference(sys.argv[2], sys.argv[3])
