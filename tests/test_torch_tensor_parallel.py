"""Tensor parallelism over ``model``, held to the JAX package's sharded
functions on the same mesh.

The port's side: ``sharding.TensorParallel`` (heads, kv heads, ``ff`` and
the vocabulary split over ``model``; in training and prefill the
residual's d_model too), ``param_specs`` / ``decode_specs``,
``bridge.shard_train`` / ``gather_train`` / ``shard_decode``,
``loss_fn`` / ``train_step`` / ``prefill`` / ``serve_step(..., rules)``
and ``train.optim._sync_grads`` (each whole leaf's gradient summed over
``model``).

The JAX reference runs in one subprocess, this file run as a script
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before jax
loads, meshes of Auto axes, ``make_rules(mesh)``: GSPMD splits the same
dims); the port in one launch of 4 gloo ranks on the CPU.  The fixture
starts both at once; they read the same inputs (``inputs.npz``: the JAX
package's ``init_params`` weights, numpy batches and decode pools).

Cases (``CASES``), reduced configs: yi-6b in f32 and bf16 on (data 2,
model 2) and on (1, 4) (its one kv head whole, each rank's q heads one
group's); phi-tiny-moe at 12 / 3 heads (6 q heads a rank straddle kv head
1: k and v expanded to the rank's q heads); yi-6b at 6 / 2 heads on (1, 4)
(the q heads do not divide: JAX's "seq" layout, each rank a block of q
rows); yi-6b at 4 / 2 heads (kv heads split); command-r-35b (parallel
block, tied vocabulary); qwen2-vl-72b (nonzero qkv biases, M-RoPE,
prefix embeddings); musicgen-medium (per-codebook tables and heads);
qwen2-moe (the shared expert tensor-parallel, the experts over
``model``); yi-6b with a vocabulary of 511 (whole on every rank).  Held:
``value_and_grad(loss_fn)``'s nll and every gradient (f32 within 1e-5 of
a leaf's largest entry, bf16 within 2^-4), two ``train_step``s' metrics
and parameters, ``prefill``'s last logits and KV, two ``serve_step``s'
logits (bf16 under tests/test_torch_engine.py's near-tie guard); in f32
also the port's unsharded gradients within 1e-5.  Every rank's leaves
are its block of the unsharded tree (``init_params(..., rules)``,
``shard_decode``).
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

from test_torch_sharded_train import (_bits, _flatten, _hold_tree,
                                      _sharded_grads, _unflatten,
                                      _unsharded_grads)
from test_torch_sharding import BS, _pools

AXES = ("data", "model")
SEQ = 16
B = 4
LR = 1e-3
DECODE_STEPS = 2
#: each row's first decode position
POS = (21, 12, 17, 9)
#: case -> (arch, dtype, mesh shape, config changes)
CASES = {
    "yi-6b-f32": ("yi-6b", "float32", (2, 2), {}),
    "yi-6b-bf16": ("yi-6b", "bfloat16", (2, 2), {}),
    "yi-6b-1x4-f32": ("yi-6b", "float32", (1, 4), {}),
    "straddle-f32": ("phi-tiny-moe", "float32", (2, 2),
                     dict(num_heads=12, num_kv_heads=3)),
    "seq-f32": ("yi-6b", "float32", (1, 4), dict(num_heads=6,
                                                 num_kv_heads=2)),
    "kv-split-f32": ("yi-6b", "float32", (2, 2), dict(num_kv_heads=2)),
    "command-r-f32": ("command-r-35b", "float32", (2, 2), {}),
    "qwen2-vl-f32": ("qwen2-vl-72b", "float32", (2, 2), {}),
    "musicgen-f32": ("musicgen-medium", "float32", (2, 2), {}),
    "qwen2-moe-f32": ("qwen2-moe", "float32", (2, 2), {}),
    "vocab-511-f32": ("yi-6b", "float32", (2, 2), dict(vocab_size=511)),
}
#: f32: gradients, logits and KV within this much of the largest entry
#: (logits and KV: elementwise, rtol and atol)
F32_REL = 1e-5
#: bf16 gradients: within this much of each leaf's largest entry
BF16_GRAD_REL = 2.0 ** -4
#: bf16 losses; the gradient norm as chip_smoke.py holds a sharded step
#: to the unsharded one (``SHARDED_GNORM_REL``)
BF16_LOSS_REL = 1e-3
BF16_GNORM_REL = 1e-2
#: bf16 prefill KV: within this many bf16 steps at each entry's magnitude
#: (at least 1): the stream it is projected from is a step or two apart
BF16_KV_STEPS = 2
#: (case, "prefill" or "decode") -> the bf16 logit vectors (step * B +
#: row; a rank's rows in prefill) where a near tie's deciding logits
#: differ by a bf16 step; the tokens are equal there too
KNOWN_NEAR_TIES = {("yi-6b-bf16", "decode"): (5,)}
TIMEOUT_S = 400


def _configs(case):
    """(JAX config, port config) of a case: reduced, with its changes."""
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    arch, _, _, changes = CASES[case]
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(t_get_config(arch).reduced(), **changes))


def _npre(cfg):
    return cfg.modality.num_prefix_embeddings if cfg.modality else 0


def _ncb(cfg):
    return cfg.modality.num_codebooks if cfg.family == "audio" else 0


def _positions_3d(npre, s):
    """(t, h, w) ids: the prefix a 4-wide grid at t 0, then text whose t, h
    and w differ."""
    p3 = np.zeros((npre + s, 3), np.int32)
    i = np.arange(npre)
    p3[:npre] = np.stack([0 * i, i // 4, i % 4], -1)
    j = np.arange(s)
    p3[npre:] = np.stack([2 + j, 5 + 2 * j, 3 + 3 * j], -1)
    return p3


def _batch(cfg, seed):
    """A numpy batch of B rows of SEQ tokens (the audio family's a
    codebook each), prefix embeddings and M-RoPE ids where the model
    reads them, a few labels masked."""
    rng = np.random.default_rng(seed)
    tail = (_ncb(cfg),) if _ncb(cfg) else ()
    npre = _npre(cfg)
    out = dict(
        tokens=rng.integers(0, cfg.vocab_size, (B, SEQ) + tail).astype(
            np.int32),
        labels=rng.integers(0, cfg.vocab_size, (B, SEQ) + tail).astype(
            np.int32),
        positions=np.broadcast_to(np.arange(npre + SEQ, dtype=np.int32),
                                  (B, npre + SEQ)).copy())
    out["labels"][0, :3] = -1
    out["labels"][-1, -2:] = -1
    if npre:
        import ml_dtypes
        pre = (0.5 * rng.normal(size=(B, npre, cfg.d_model))).astype(
            np.float32)
        out["prefix_embeddings"] = pre.astype(ml_dtypes.bfloat16).astype(
            np.float32)
    if cfg.rope_style == "mrope":
        out["positions_3d"] = np.broadcast_to(
            _positions_3d(npre, SEQ), (B, npre + SEQ, 3)).copy()
    return out


def _decode_inputs(cfg, seed):
    """Pools over 4 shards holding each row's blocks up to its last
    decode position, and per step the tokens fed, positions, append slots
    and offsets (and M-RoPE ids)."""
    rng = np.random.default_rng(seed)
    blocks = [(r, j) for r, p in enumerate(POS)
              for j in range((p + DECODE_STEPS - 1) // BS + 1)]
    (k, v, sr, sb), where = _pools(rng, blocks, 4, cfg.num_layers,
                                   cfg.num_kv_heads, cfg.resolved_head_dim)
    p = np.asarray(POS, np.int32)[None] + np.arange(
        DECODE_STEPS, dtype=np.int32)[:, None]
    tail = (_ncb(cfg),) if _ncb(cfg) else ()
    out = dict(pool_k=k, pool_v=v, sr=sr, sb=sb, pos=p,
               aslot=np.asarray([[where[(r, q // BS)]
                                  for r, q in enumerate(row)] for row in p],
                                np.int32),
               aoff=(p % BS).astype(np.int32),
               tokens=rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B)
                                   + tail).astype(np.int32))
    if cfg.rope_style == "mrope":
        out["p3"] = np.stack([np.stack([pp + 2, pp + 1, pp + 3], -1)
                              for pp in p]).astype(np.int32)
    return out


def _build_inputs(path):
    import jax

    from repro.models import model as JM

    flat = {}
    for i, case in enumerate(CASES):
        cfg, _ = _configs(case)
        tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                       cfg))
        if cfg.attn_bias:       # nonzero biases, so that their split shows
            rng = np.random.default_rng(3)
            attn = tree["layers"]["attn"]
            for name in ("bq", "bk", "bv"):
                attn[name] = (0.5 * rng.normal(size=attn[name].shape)).astype(
                    attn[name].dtype)
        flat.update(_flatten(jax.tree.map(_bits, tree), f"{case}/params/"))
        for step in range(2):
            flat.update(_flatten(_batch(cfg, 200 + 10 * i + step),
                                 f"{case}/batch{step}/"))
        flat.update(_flatten(_decode_inputs(cfg, 300 + i), f"{case}/dec/"))
    np.savez(path, **flat)


def _case_batch(inp, case, step):
    pre = f"{case}/batch{step}/"
    return {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}


def _case_dec(inp, case):
    pre = f"{case}/dec/"
    return {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# the JAX reference (this file run as a script, in its own process)
# ---------------------------------------------------------------------------


def _jax_params(inp, case, dtype):
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    tree = jax.tree.map(lambda a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a),
        _unflatten(inp, f"{case}/params/"))
    if dtype == "float32":      # the same weights widened (exact)
        tree = jax.tree.map(lambda a: a.astype(jnp.float32), tree)
    return tree


def _jax_batch(b, dtype):
    import jax.numpy as jnp
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "prefix_embeddings" in out:
        out["prefix_embeddings"] = out["prefix_embeddings"].astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return out


def _jax_reference(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_rules
    from repro.models import model as JM
    from repro.train import optim as JO

    inp = dict(np.load(inputs_path))
    out = {}
    for case, (_, dtype, shape, _) in CASES.items():
        cfg, _ = _configs(case)
        params = _jax_params(inp, case, dtype)
        rules = make_rules(jax.make_mesh(shape, AXES, axis_types=(
            jax.sharding.AxisType.Auto,) * 2))
        batches = [_jax_batch(_case_batch(inp, case, s), dtype)
                   for s in range(2)]
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, b, cfg, rules), has_aux=True))(
                params, batches[0])
        out.update({f"{case}/grads/{k}": np.asarray(v, np.float32)
                    for k, v in _flatten(grads, "").items()})
        out[f"{case}/metrics"] = np.asarray([float(metrics["nll"]),
                                             float(metrics["aux"])])
        pbatch = {k: v for k, v in batches[0].items() if k != "labels"}
        last, fo = jax.jit(lambda p, b: JM.prefill(p, b, cfg, rules))(
            params, pbatch)
        out[f"{case}/prefill/logits"] = np.asarray(last, np.float32)
        out[f"{case}/prefill/k"] = np.asarray(fo.kv[0], np.float32)
        out[f"{case}/prefill/v"] = np.asarray(fo.kv[1], np.float32)
        g = _case_dec(inp, case)
        zero = jnp.zeros((B,), jnp.int32)
        st = JM.DecodeState(
            tokens=None, pos=None, peer=None, states=None,
            kv=JM.KVPools(*(jnp.asarray(g[k]).astype(
                jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
                for k in ("pool_k", "pool_v")), jnp.asarray(g["sr"]),
                jnp.asarray(g["sb"]), zero, zero))
        serve = jax.jit(lambda p, s: JM.serve_step(p, s, cfg, rules))
        logs = []
        for t in range(DECODE_STEPS):
            st = st._replace(
                tokens=jnp.asarray(g["tokens"][t]),
                pos=jnp.asarray(g["pos"][t]),
                positions_3d=(jnp.asarray(g["p3"][t]) if "p3" in g
                              else None),
                kv=st.kv._replace(append_slot=jnp.asarray(g["aslot"][t]),
                                  append_off=jnp.asarray(g["aoff"][t])))
            logits, st = serve(params, st)
            logs.append(np.asarray(logits, np.float32))
        out[f"{case}/decode/logits"] = np.stack(logs)
        step = jax.jit(lambda p, o, b: JO.train_step(p, o, b, cfg, rules,
                                                     lr=LR))
        opt = JO.adamw_init(params)
        for s in range(2):
            params, opt, m = step(params, opt, batches[s])
            for k, v in m.items():
                out[f"{case}/step{s}/{k}"] = np.asarray(v)
        out.update({f"{case}/params/{k}": np.asarray(v, np.float32)
                    for k, v in _flatten(params, "").items()})
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port (4 gloo ranks)
# ---------------------------------------------------------------------------


def _port_params(inp, case, cfg, dtype):
    from repro_torch.bridge import params_from_numpy
    full = params_from_numpy(_unflatten(inp, f"{case}/params/"), cfg, "cpu")
    if dtype == "float32":      # the same weights widened (exact)
        full = _unflatten({k: v.float() for k, v in
                           _flatten(full, "").items()}, "")
    return full


def _port_batch(b, dtype):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if "prefix_embeddings" in out:
        out["prefix_embeddings"] = out["prefix_embeddings"].to(
            torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return out


def _is_block(shards, whole, specs, rules) -> bool:
    """Every leaf of ``shards`` is its block of ``whole`` as ``specs``
    split it, bit for bit."""
    from repro_torch.models.sharding import shard_slices
    s, w, sp = (_flatten(t, "") for t in (shards, whole, specs))
    return all(torch.equal(s[k], w[k][shard_slices(rules, sp[k],
                                                   w[k].shape)])
               for k in w)


def _decode_specs(cfg, rules):
    """``decode_specs`` with each MoE layer's experts over ``model``, as
    ``shard_decode`` cuts them where the batch takes the expert-parallel
    path (every case here)."""
    from repro_torch.models import params as TP
    specs = TP.decode_specs(cfg, rules)
    moe = specs.get("layers", {}).get("moe")
    if moe is not None:
        moe.update({k: (None, "model") + moe[k][2:]
                    for k in ("wi", "wg", "wo")})
    return specs


def _decode(TM, params, g, cfg, dtype, rules):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    zero = torch.zeros((B,), dtype=torch.int32)
    st = TM.DecodeState(
        tokens=torch.from_numpy(g["tokens"][0]),
        pos=torch.from_numpy(g["pos"][0]), peer=None,
        kv=TM.KVPools(*(torch.from_numpy(g[k].copy()).to(dt)
                        for k in ("pool_k", "pool_v")),
                      torch.from_numpy(g["sr"]), torch.from_numpy(g["sb"]),
                      zero, zero))
    if rules is not None:
        from repro_torch.bridge import shard_decode
        params, st = shard_decode(params, st, cfg, rules)
    logs = []
    for t in range(DECODE_STEPS):
        st = st._replace(
            tokens=torch.from_numpy(g["tokens"][t]),
            pos=torch.from_numpy(g["pos"][t]),
            positions_3d=(torch.from_numpy(g["p3"][t]) if "p3" in g
                          else None),
            kv=st.kv._replace(append_slot=torch.from_numpy(g["aslot"][t]),
                              append_off=torch.from_numpy(g["aoff"][t])))
        logits, st = TM.serve_step(params, st, cfg, rules=rules)
        logs.append(logits.float().numpy())
    return np.stack(logs), params


def _port_case(case, inp, rules, rank):
    from repro_torch.bridge import gather_train, shard_train
    from repro_torch.models import model as TM
    from repro_torch.models import params as TP
    from repro_torch.train import optim as O

    _, dtype, _, _ = CASES[case]
    _, cfg = _configs(case)
    batches = [_port_batch(_case_batch(inp, case, s), dtype)
               for s in range(2)]
    res = {}
    # a step updates the leaves no axis splits in place, and a rank's
    # shard shares them: each use starts from fresh weights
    full = _port_params(inp, case, cfg, dtype)
    p, _ = shard_train(full, None, cfg, rules)
    specs = TP.param_specs(cfg, rules)
    res["train_block"] = _is_block(p, full, specs, rules)
    res["over_model"] = sum("model" in sp for sp in _flatten(specs,
                                                             "").values())
    with torch.no_grad():
        pbatch = {k: v for k, v in batches[0].items() if k != "labels"}
        last, fo = TM.prefill(p, pbatch, cfg, rules)
    res["prefill/logits"] = last.float().numpy()
    res["prefill/k"] = fo.kv[0].float().numpy()
    res["prefill/v"] = fo.kv[1].float().numpy()
    g = _case_dec(inp, case)
    res["decode/logits"], pd = _decode(TM, full, g, cfg, dtype, rules)
    res["decode_block"] = _is_block(pd, full, _decode_specs(cfg, rules),
                                    rules)
    res["metrics"], res["gnorm"], res["grads"] = _sharded_grads(
        TM, O, p, batches[0], cfg, rules)
    opt = O.adamw_init(p)
    res["steps"] = []
    for s in range(2):
        p, opt, m = O.train_step(p, opt, batches[s], cfg, rules, lr=LR)
        res["steps"].append({k: float(v) for k, v in m.items()})
    pf, _ = gather_train(p, None, cfg, rules)
    if rank == 0:
        res["params"] = {k: v.float().numpy()
                         for k, v in _flatten(pf, "").items()}
    if dtype == "float32":
        # without the load-balance term (its per-shard form differs by
        # design), against the unsharded port
        flat = dataclasses.replace(cfg, moe=None if cfg.moe is None else
                                   dataclasses.replace(cfg.moe,
                                                       lb_loss_weight=0.0))
        ps, _ = shard_train(_port_params(inp, case, cfg, dtype), None, flat,
                            rules)
        res["lossless"] = _sharded_grads(TM, O, ps, batches[0], flat, rules)
        if rank == 0:
            res["unsharded"] = _unsharded_grads(
                TM, O, _port_params(inp, case, cfg, dtype), batches[0], flat)
    return res


def _port_ranks(rank, world, inputs_path):
    """Every case on this rank, and ``init_params(..., rules)`` against
    the rank's block of the unsharded draw."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import params as TP

    inp = dict(np.load(inputs_path))
    meshes = {shape: make_rules(Mesh(shape, AXES))
              for shape in dict.fromkeys(s for _, _, s, _ in CASES.values())}
    out = {"coords": meshes[(2, 2)].mesh.coords}
    for case, (_, _, shape, _) in CASES.items():
        out[case] = _port_case(case, inp, meshes[shape], rank)
    for case in ("musicgen-f32", "qwen2-moe-f32", "yi-6b-1x4-f32"):
        _, cfg = _configs(case)
        rules = meshes[CASES[case][2]]
        mine = TP.init_params(cfg, torch.Generator().manual_seed(5), "cpu",
                              rules=rules)
        whole = TP.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        out[f"init/{case}"] = (
            _is_block(mine, whole, TP.param_specs(cfg, rules), rules),
            {k: tuple(v.shape) for k, v in _flatten(mine, "").items()})
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each port rank's results)."""
    from repro_torch.launch.mesh import launch

    tmp = tmp_path_factory.mktemp("tensor_parallel")
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
    return dict(np.load(jax_out)), ranks


def _f32(case):
    return CASES[case][1] == "float32"


def _want(ref, pre):
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_gradients_match_jax(runs, case):
    """``loss_fn``'s nll and aux and every gradient (gathered whole)
    against ``jax.value_and_grad`` of JAX's ``loss_fn`` under the same
    mesh's rules; every rank gathers the same gradients, and some leaf of
    every case is split over ``model``."""
    ref, ranks = runs
    r0 = ranks[0][case]
    rel = F32_REL if _f32(case) else BF16_GRAD_REL
    _hold_tree(r0["grads"], _want(ref, f"{case}/grads/"), rel, "grads")
    nll, aux = ref[f"{case}/metrics"]
    tol = F32_REL if _f32(case) else BF16_LOSS_REL
    np.testing.assert_allclose(r0["metrics"]["nll"], nll, rtol=tol)
    np.testing.assert_allclose(r0["metrics"]["aux"], aux, rtol=tol, atol=1e-7)
    assert r0["over_model"] > 0
    for r in ranks[1:]:
        for k, g in r[case]["grads"].items():
            assert np.array_equal(g, r0["grads"][k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_train_steps_match_jax(runs, case):
    """Two ``train_step(..., rules)`` calls against JAX's jitted
    ``train_step``: each step's loss, nll and grad_norm (every rank the
    same), and every parameter after the second, gathered: f32 each
    within 2 lr a step and all but 1e-4 of them within 2e-6 (a gradient
    entry within f32 noise of 0 moves its parameter by that noise's sign,
    tests/test_torch_sharded_train.py), bf16 each within 2 lr a step plus
    a bf16 step of its size."""
    ref, ranks = runs
    r0 = ranks[0][case]
    f32 = _f32(case)
    for s in range(2):
        for k in ("loss", "nll", "grad_norm"):
            tol = F32_REL if f32 else (BF16_GNORM_REL if k == "grad_norm"
                                       else BF16_LOSS_REL)
            np.testing.assert_allclose(
                r0["steps"][s][k], float(ref[f"{case}/step{s}/{k}"]),
                rtol=tol, err_msg=f"step {s} {k}")
    for r in ranks[1:]:
        assert r[case]["steps"] == r0["steps"]
    want = _want(ref, f"{case}/params/")
    assert r0["params"].keys() == want.keys()
    off = total = 0
    for k, w in want.items():
        d = np.abs(r0["params"][k] - w)
        if f32:
            assert d.max() <= 2 * LR * 2, k
            off += int((d > 2e-6).sum())
            total += d.size
        else:
            assert np.all(d <= 2 * LR * 2 + 2.0 ** -7 * np.maximum(
                np.abs(r0["params"][k]), np.abs(w))), k
    assert off <= 1e-4 * total, (off, total)


@pytest.mark.parametrize("case", [c for c in CASES if _f32(c)])
def test_tensor_parallel_matches_unsharded_port(runs, case):
    """f32, without the load-balance term: the tensor-parallel nll,
    gradient norm and every gradient within ``F32_REL`` of the port's own
    unsharded ``loss_fn`` (the ranks' partial products round apart before
    their sum)."""
    _, ranks = runs
    r0 = ranks[0][case]
    (m, gnorm, grads), (um, ugnorm, ugrads) = r0["lossless"], r0["unsharded"]
    np.testing.assert_allclose(m["nll"], um["nll"], rtol=F32_REL)
    np.testing.assert_allclose(gnorm, ugnorm, rtol=F32_REL)
    _hold_tree(grads, ugrads, F32_REL, "grads")


def _rows(rank, shape):
    """The batch rows of a rank of ``shape`` (its data index's)."""
    k = B // shape[0]
    i = rank // shape[1]
    return slice(i * k, (i + 1) * k)


def _check_logits(want, got, case, what):
    from test_torch_engine import _check_sampled_logits
    if _f32(case):
        np.testing.assert_allclose(got, want, rtol=F32_REL, atol=F32_REL,
                                   err_msg=what)
        return
    jv, tv = want.reshape(-1, want.shape[-1]), got.reshape(-1, got.shape[-1])
    _check_sampled_logits(list(jv), list(tv),
                          KNOWN_NEAR_TIES.get((case, what), ()))
    assert all(a.argmax() == b.argmax() for a, b in zip(jv, tv)), what


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_prefill_matches_jax(runs, case):
    """``prefill(rules)``: each rank's rows of the last logits (whole
    along the vocabulary) and of the KV (every kv head) against JAX's
    sharded ``prefill``; the ``model`` ranks of one data index alike."""
    ref, ranks = runs
    shape = CASES[case][2]
    for rank, r in enumerate(ranks):
        rows = _rows(rank, shape)
        _check_logits(ref[f"{case}/prefill/logits"][rows],
                      r[case]["prefill/logits"], case, "prefill")
        for name in ("k", "v"):
            want = ref[f"{case}/prefill/{name}"][:, rows]
            got = r[case][f"prefill/{name}"]
            if _f32(case):
                np.testing.assert_allclose(got, want, rtol=F32_REL,
                                           atol=F32_REL)
            else:
                step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                           1.0))) - 7)
                assert np.all(np.abs(got - want) <= BF16_KV_STEPS * step)
        lead = ranks[rank - rank % shape[1]][case]
        assert np.array_equal(r[case]["prefill/logits"],
                              lead["prefill/logits"])


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_serve_step_matches_jax(runs, case):
    """Two ``serve_step(rules)`` steps from ``shard_decode``'s shards (the
    attention, MLP and vocabulary weights split over ``model``, the pools'
    slots over every rank) against JAX's sharded ``serve_step``: whole
    logits, the same on every rank."""
    ref, ranks = runs
    want = ref[f"{case}/decode/logits"]
    for r in ranks:
        assert np.array_equal(r[case]["decode/logits"],
                              ranks[0][case]["decode/logits"])
    _check_logits(want, ranks[0][case]["decode/logits"], case, "decode")


def test_each_rank_holds_its_block(runs):
    """``shard_train`` and ``shard_decode`` leave each rank exactly its
    block of every leaf, and ``init_params(..., rules)`` draws it: the
    same bits as the unsharded draw's block; the heads, kv heads (where
    they divide), ``ff`` (the shared expert's too) and the vocabulary
    (per codebook) split over ``model``, d_model over ``data``."""
    _, ranks = runs
    for r in ranks:
        for case in CASES:
            assert r[case]["train_block"] and r[case]["decode_block"], case
        for case in ("musicgen-f32", "qwen2-moe-f32", "yi-6b-1x4-f32"):
            assert r[f"init/{case}"][0], case
    music = ranks[0]["init/musicgen-f32"][1]
    assert music["embed"] == (4, 256, 128)
    assert music["lm_head"] == (4, 128, 256)
    assert music["layers/attn/wk"] == (2, 128, 2, 64)
    assert music["layers/mlp/wi"] == (2, 128, 256)
    moe = ranks[0]["init/qwen2-moe-f32"][1]
    assert moe["layers/moe/shared/wi"] == (2, 128, 128)
    assert moe["layers/moe/wi"] == (2, 2, 128, 256)
    assert moe["layers/moe/router"] == (2, 128, 4)
    yi = ranks[0]["init/yi-6b-1x4-f32"][1]
    assert yi["layers/attn/wq"] == (2, 256, 1, 64)
    assert yi["layers/attn/wk"] == (2, 256, 1, 64)
    assert yi["embed"] == (128, 256)
    assert yi["layers/mlp/wo"] == (2, 128, 256)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-reference"]:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    _jax_reference(sys.argv[2], sys.argv[3])
