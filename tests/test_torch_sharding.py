"""Decode with the KV pool and the experts sharded over ranks, held to the
JAX package's sharded functions on a (data 2, model 2) mesh.

The port's side: ``repro_torch.launch.mesh`` (a mesh of ranks over
``torch.distributed``, its rules and its launcher),
``repro_torch.models.sharding``, the cross-rank merge of
``core.paged_attention.finalize``, ``serve_step(..., rules=rules)`` and
``moe_layer(..., rules=rules)`` (expert parallelism), and
``bridge.shard_decode`` (each rank's experts and slots).

The JAX reference runs in one subprocess, this file run as a script: it
sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before jax
loads, builds a (2, 2) mesh of Auto axes (the package's own
``launch/mesh.py`` builds its meshes so; under Explicit axes ``shard``
refuses its constraints) and computes every case.  The port runs in one
launch of 4 gloo ranks on the CPU that computes every case too.  The
fixture starts both at once; they read the same inputs (``inputs.npz``).

Cases:
- ``finalize`` across 2 ranks (``model``) and 4 (``data`` x ``model``)
  against ``finalize(axis_names=...)`` inside ``shard_map``, with a row
  that has no block on some ranks and one that has none on any;
- four decode steps of ``serve_step(rules)`` against JAX's
  ``serve_step(rules)`` (its scan that carries the pools, as the JAX
  engine calls it) and against the port's unsharded step, the tokens fed
  (not sampled), in f32 and bf16: reduced yi-6b, h2o-danube-3-4b with
  rows past its 64-token window, qwen2-moe (its MoE layers take
  ``_moe_layer_local``: 2 of 4 experts a rank) and yi-6b in place with
  each row's first block on a peer pool sharded the same way.  f32:
  logits and each rank's pool shards within 1e-5 of JAX's.  bf16: every
  step's logits under the near-tie guard of tests/test_torch_engine.py
  (the tokens identical), the appended pool entries a bf16 step apart at
  most, the others bit for bit;
- ``moe_layer(rules)`` against ``_moe_layer_local`` at capacity factor 8
  (nothing dropped) and at 1.0, where each shard's capacity drops
  tokens: the same dropped (token, expert) pairs, outputs, and the
  load-balance loss.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

MESH = (2, 2)
AXES = ("data", "model")
BS, STEPS, B = 8, 4, 4
#: case -> (arch, dtype, in place, each row's first decode position)
SERVE = {
    "yi-6b-f32": ("yi-6b", "float32", False, (41, 24, 33, 17)),
    "yi-6b-bf16": ("yi-6b", "bfloat16", False, (41, 24, 33, 17)),
    # rows past the reduced 64-token window
    "danube-f32": ("h2o-danube-3-4b", "float32", False, (150, 101, 70, 5)),
    "danube-bf16": ("h2o-danube-3-4b", "bfloat16", False, (150, 101, 70, 5)),
    "qwen2-moe-f32": ("qwen2-moe", "float32", False, (41, 24, 33, 17)),
    "qwen2-moe-bf16": ("qwen2-moe", "bfloat16", False, (41, 24, 33, 17)),
    "yi-6b-inplace-f32": ("yi-6b", "float32", True, (41, 24, 33, 17)),
    "yi-6b-inplace-bf16": ("yi-6b", "bfloat16", True, (41, 24, 33, 17)),
}
#: case -> (dtype, capacity factor); reduced qwen2-moe's layer, 4 rows
#: of 8 tokens: 16 a data shard, routed top-2 over 4 experts
MOE = {"cf8-f32": ("float32", 8.0), "cf1-f32": ("float32", 1.0),
       "cf1-bf16": ("bfloat16", 1.0)}
MOE_SEQ = 8
#: finalize cases -> the mesh axes the partials are merged over
FINALIZE = {2: ("model",), 4: ("data", "model")}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16 logit vectors (step * B + row) where JAX's top-1/top-2 gap is
#: under twice the step's largest difference and the two deciding logits
#: differ by a bf16 step (GSPMD's reordered sums, and XLA's fusions
#: against eager PyTorch, ROADMAP C); the tokens are equal there but at
#: ``EXACT_TIES``
KNOWN_NEAR_TIES = {"yi-6b-bf16": (14,), "danube-bf16": (5, 10, 13)}
#: vectors where JAX's two leading logits tie exactly (its unsharded step
#: ties there too) and the port's differ by a bf16 step: the port's
#: token is the other of the two
EXACT_TIES = {"danube-bf16": (5,)}
TIMEOUT_S = 300


def _config(get_config, arch):
    return get_config(arch).reduced()


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


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _bits(a):
    """A JAX leaf as numpy, bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# inputs, shared by both sides
# ---------------------------------------------------------------------------


def _pools(rng, owned, shards, L, nkv, hd):
    """A pool holding ``owned`` (row, block) pairs in shuffled slots, f32
    values, the rest free slots of garbage; its slot count a multiple of
    ``shards`` with at least 4 free.  Returns (k, v, slot_req,
    slot_base), {(row, block): slot}."""
    n = -(-(len(owned) + 4) // shards) * shards
    slots = rng.permutation(n)[:len(owned)]
    k = rng.normal(size=(L, n, BS, nkv, hd)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    sr = np.full((n,), -1, np.int32)
    sb = rng.integers(0, 256, size=n).astype(np.int32)
    where = {}
    for (r, j), s in zip(owned, slots):
        sr[s], sb[s] = r, j * BS
        where[(r, j)] = int(s)
    return (k, v, sr, sb), where


def _serve_inputs(case, cfg, seed):
    """The decode state of a serve case: the local pool (every block but
    those on the peer), the peer pool (each row's first block, in
    place), and per step the tokens fed, the positions, append slots and
    offsets."""
    _, _, inplace, pos = SERVE[case]
    rng = np.random.default_rng(seed)
    L, nkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    shards = MESH[0] * MESH[1]
    blocks = [(r, j) for r, p in enumerate(pos)
              for j in range((p + STEPS - 1) // BS + 1)]
    on_peer = [(r, 0) for r in range(B)] if inplace else []
    local, where = _pools(rng, [rj for rj in blocks if rj not in on_peer],
                          shards, L, nkv, hd)
    out = dict(zip(("local_k", "local_v", "local_sr", "local_sb"), local))
    if inplace:
        peer, _ = _pools(rng, on_peer, shards, L, nkv, hd)
        out.update(zip(("peer_k", "peer_v", "peer_sr", "peer_sb"), peer))
    p = np.asarray(pos, np.int32)[None] + np.arange(STEPS, dtype=np.int32)[
        :, None]                                      # (STEPS, B)
    out["pos"] = p
    out["aslot"] = np.asarray([[where[(r, q // BS)] for r, q in enumerate(row)]
                               for row in p], np.int32)
    out["aoff"] = (p % BS).astype(np.int32)
    out["tokens"] = rng.integers(0, cfg.vocab_size, size=(STEPS, B)).astype(
        np.int32)
    return out


def _finalize_inputs(seed=5, b=4, nkv=2, gq=2, hd=16):
    """Flash-decode partials of 4 shards: row 1 has no block on shards 1
    and 3, row 3 none on any (m -1e30, l 0, acc 0)."""
    rng = np.random.default_rng(seed)
    m = (3 * rng.normal(size=(4, b, nkv, gq))).astype(np.float32)
    l = rng.uniform(0.5, 4.0, size=m.shape).astype(np.float32)
    acc = rng.normal(size=m.shape + (hd,)).astype(np.float32)
    for s, r in ((1, 1), (3, 1), (0, 3), (1, 3), (2, 3), (3, 3)):
        m[s, r], l[s, r], acc[s, r] = -1e30, 0.0, 0.0
    return dict(m=m, l=l, acc=acc)


def _build_inputs(path):
    """Every case's inputs, the parameters drawn by the JAX package's
    ``init_params`` (bf16 leaves as uint16 bits), written to ``path``."""
    import jax

    from repro.configs import get_config
    from repro.models import model as JM

    flat = {f"finalize/{k}": v for k, v in _finalize_inputs().items()}
    for i, case in enumerate(SERVE):
        arch, dtype, _, _ = SERVE[case]
        cfg = _config(get_config, arch)
        params = jax.tree.map(_bits, JM.init_params(jax.random.PRNGKey(0),
                                                    cfg))
        flat.update(_flatten(params, f"{case}/params/"))
        flat.update(_flatten(_serve_inputs(case, cfg, 100 + i), f"{case}/"))
    cfg = _config(get_config, "qwen2-moe")
    lp = JM.init_params(jax.random.PRNGKey(0), cfg)["layers"]["moe"]
    rng = np.random.default_rng(7)
    for case, (dtype, _) in MOE.items():
        p = jax.tree.map(lambda t: np.asarray(t[0], np.float32), lp)
        p["router"] = (4 * p["router"]).astype(np.float32)   # sharper routing
        x = rng.normal(size=(B, MOE_SEQ, cfg.d_model)).astype(np.float32)
        if dtype == "bfloat16":
            import ml_dtypes
            p = {k: (v if k == "router" else
                     v.astype(ml_dtypes.bfloat16).view(np.uint16))
                 for k, v in _flatten(p, "").items()}
            p = _unflatten(p, "")
            x = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        flat.update(_flatten(p, f"moe/{case}/params/"))
        flat[f"moe/{case}/x"] = x
    np.savez(path, **flat)


# ---------------------------------------------------------------------------
# the JAX reference (this file run as a script, in its own process)
# ---------------------------------------------------------------------------


def _jax_reference(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core import paged_attention as jpa
    from repro.launch.mesh import make_rules
    from repro.models import model as JM
    from repro.models import moe as JMOE
    from repro.models.sharding import shard_map

    inp = dict(np.load(inputs_path))
    mesh = jax.make_mesh(MESH, AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = make_rules(mesh)
    out = {}

    # finalize over 2 and 4 shards
    parts = [inp[f"finalize/{k}"] for k in ("m", "l", "acc")]
    for n, axes in FINALIZE.items():
        def fin(m, l, acc, axes=axes):
            return jpa.finalize(jpa.Partials(m[0], l[0], acc[0]), axes)[None]
        spec = P(axes)
        got = jax.jit(shard_map(fin, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=spec, check_vma=False))(
            *(jnp.asarray(a[:n]) for a in parts))
        out[f"finalize/{n}"] = np.asarray(got)

    def tree(prefix, bf16):
        t = _unflatten(inp, prefix)
        return jax.tree.map(lambda a: jnp.asarray(
            a.view(ml_dtypes.bfloat16) if bf16 and a.dtype == np.uint16
            else a), t)

    for case, (arch, dtype, inplace, _) in SERVE.items():
        cfg = _config(get_config, arch)
        params = tree(f"{case}/params/", True)
        if dtype == "float32":      # the same weights widened (exact)
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        g = {k[len(case) + 1:]: v for k, v in inp.items()
             if k.startswith(case + "/") and "/params/" not in k}
        zero = jnp.zeros((B,), jnp.int32)

        def pools(w):
            return JM.KVPools(*(jnp.asarray(g[f"{w}_{k}"])
                                for k in ("k", "v", "sr", "sb")), zero, zero)

        st = JM.DecodeState(tokens=None, pos=None, kv=pools("local"),
                            peer=pools("peer") if inplace else None,
                            states=None)
        step = jax.jit(lambda p, s, cfg=cfg, inplace=inplace: JM.serve_step(
            p, s, cfg, rules, harvest_inplace=inplace))
        logs = []
        for t in range(STEPS):
            st = st._replace(
                tokens=jnp.asarray(g["tokens"][t]),
                pos=jnp.asarray(g["pos"][t]),
                kv=st.kv._replace(append_slot=jnp.asarray(g["aslot"][t]),
                                  append_off=jnp.asarray(g["aoff"][t])))
            logits, st = step(params, st)
            logs.append(np.asarray(logits, np.float32))
        out[f"{case}/logits"] = np.stack(logs)
        out[f"{case}/pool_k"] = np.asarray(st.kv.pool_k)
        out[f"{case}/pool_v"] = np.asarray(st.kv.pool_v)
        if inplace:
            out[f"{case}/peer_k"] = np.asarray(st.peer.pool_k)

    cfg = _config(get_config, "qwen2-moe")
    for case, (dtype, cf) in MOE.items():
        p = tree(f"moe/{case}/params/", True)
        x = inp[f"moe/{case}/x"]
        x = jnp.asarray(x.view(ml_dtypes.bfloat16) if x.dtype == np.uint16
                        else x)
        y, aux = jax.jit(lambda x, p, cfg=cfg, cf=cf: JMOE.moe_layer(
            x, p, cfg, rules, capacity_factor=cf))(x, p)
        out[f"moe/{case}/y"] = np.asarray(y, np.float32)
        out[f"moe/{case}/aux"] = np.asarray(aux)
        # the dropped (token, expert) pairs of each data shard, as
        # _moe_layer_local routes them
        mc, b_loc = cfg.moe, B // MESH[0]
        t_loc = b_loc * MOE_SEQ
        cap = max(int(t_loc * mc.top_k / mc.num_experts * cf), 4)
        dropped = []
        for i in range(MESH[0]):
            xt = x[i * b_loc:(i + 1) * b_loc].reshape(t_loc, -1)
            logits = jnp.einsum("td,de->te", xt, p["router"]).astype(
                jnp.float32)
            w, ids, _ = JMOE.router_topk(logits, mc.top_k)
            st_, _ = JMOE.build_dispatch(ids, w, mc.num_experts, cap)
            dropped.append(_dropped(np.asarray(ids), np.asarray(st_), cap, i))
        out[f"moe/{case}/dropped"] = np.concatenate(dropped)
    np.savez(out_path, **out)


def _dropped(ids, slot_token, cap, shard):
    """(shard, token, expert) of every routed choice that no dispatch slot
    took, sorted."""
    t = ids.shape[0]
    kept = {(int(tok), s // cap) for s, tok in enumerate(slot_token)
            if tok < t}
    return np.asarray(sorted((shard, tok, int(e)) for tok in range(t)
                             for e in ids[tok] if (tok, int(e)) not in kept),
                      np.int64).reshape(-1, 3)


# ---------------------------------------------------------------------------
# the port (4 gloo ranks)
# ---------------------------------------------------------------------------


def _torch_state(TM, g, inplace):
    zero = torch.zeros((B,), dtype=torch.int32)

    def pools(w):
        return TM.KVPools(*(torch.from_numpy(g[f"{w}_{k}"].copy())
                            for k in ("k", "v", "sr", "sb")), zero, zero)

    return TM.DecodeState(tokens=torch.from_numpy(g["tokens"][0]),
                          pos=torch.from_numpy(g["pos"][0]),
                          kv=pools("local"),
                          peer=pools("peer") if inplace else None)


def _decode(TM, params, st, cfg, g, inplace, rules):
    logs = []
    for t in range(STEPS):
        st = st._replace(
            tokens=torch.from_numpy(g["tokens"][t]),
            pos=torch.from_numpy(g["pos"][t]),
            kv=st.kv._replace(append_slot=torch.from_numpy(g["aslot"][t]),
                              append_off=torch.from_numpy(g["aoff"][t])))
        logits, st = TM.serve_step(params, st, cfg, harvest_inplace=inplace,
                                   rules=rules)
        logs.append(logits.float().numpy())
    return np.stack(logs), st


def _port_ranks(rank, world, inputs_path):
    """One rank's results of every case."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy, shard_decode
    from repro_torch.configs import get_config
    from repro_torch.core import paged_attention as tpa
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMOE

    inp = dict(np.load(inputs_path))
    mesh = Mesh(MESH, AXES)
    rules = make_rules(mesh)
    out = {"coords": mesh.coords}

    parts = [torch.from_numpy(inp[f"finalize/{k}"]) for k in ("m", "l", "acc")]
    for n, axes in FINALIZE.items():
        idx = mesh.axis_index(axes)
        out[f"finalize/{n}"] = tpa.finalize(
            tpa.Partials(*(a[idx] for a in parts)),
            group=mesh.group(axes)).numpy()

    for case, (arch, dtype, inplace, _) in SERVE.items():
        cfg = _config(get_config, arch)
        params = params_from_numpy(_unflatten(inp, f"{case}/params/"), cfg,
                                   "cpu")
        if dtype == "float32":      # the same weights widened (exact)
            params = _map(params, lambda t: t.float())
        g = {k[len(case) + 1:]: v for k, v in inp.items()
             if k.startswith(case + "/") and "/params/" not in k}
        full = _torch_state(TM, g, inplace)
        p_r, st_r = shard_decode(params, full, cfg, rules)
        out[f"{case}/experts"] = None if cfg.moe is None else \
            p_r["layers"]["moe"]["wi"].shape[1]
        logs, st = _decode(TM, p_r, st_r, cfg, g, inplace, rules)
        out[f"{case}/logits"] = logs
        out[f"{case}/pool_k"] = st.kv.pool_k.numpy()
        out[f"{case}/pool_v"] = st.kv.pool_v.numpy()
        if inplace:
            out[f"{case}/peer_k"] = st.peer.pool_k.numpy()
        if rank == 0:       # the port's unsharded step on the same inputs
            logs, st = _decode(TM, params, full, cfg, g, inplace, None)
            out[f"{case}/unsharded_logits"] = logs
            out[f"{case}/unsharded_pool_k"] = st.kv.pool_k.numpy()
            out[f"{case}/unsharded_pool_v"] = st.kv.pool_v.numpy()

    cfg = _config(get_config, "qwen2-moe")
    for case, (dtype, cf) in MOE.items():
        p = {k: torch.from_numpy(v) for k, v in
             _flatten(_unflatten(inp, f"moe/{case}/params/"), "").items()}
        x = torch.from_numpy(inp[f"moe/{case}/x"])
        if dtype == "bfloat16":
            p = {k: v if k == "router" else v.view(torch.bfloat16)
                 for k, v in p.items()}
            x = x.view(torch.bfloat16)
        p = _unflatten(p, "")
        # this rank's experts, as bridge.shard_decode cuts them
        e_loc = cfg.moe.num_experts // MESH[1]
        j = mesh.axis_index("model")
        p.update({k: p[k][j * e_loc:(j + 1) * e_loc]
                  for k in ("wi", "wg", "wo")})
        y, probs, ids = TMOE.moe_layer(x, p, cfg, capacity_factor=cf,
                                       rules=rules)
        out[f"moe/{case}/y"] = y.float().numpy()
        out[f"moe/{case}/aux"] = TMOE.load_balance_loss(
            probs, ids, cfg.moe.num_experts).numpy()
        # this rank's data shard: its routing and dispatch
        i, b_loc = mesh.axis_index("data"), B // MESH[0]
        t_loc = b_loc * MOE_SEQ
        cap = max(int(t_loc * cfg.moe.top_k / cfg.moe.num_experts * cf), 4)
        xt = x[i * b_loc:(i + 1) * b_loc].reshape(t_loc, -1)
        w, ids_i, _ = TMOE.router_topk(
            torch.einsum("td,de->te", xt.float(), p["router"].float()),
            cfg.moe.top_k)
        assert torch.equal(ids_i, ids[i])
        st_, _ = TMOE.build_dispatch(ids_i, w, cfg.moe.num_experts, cap)
        out[f"moe/{case}/dropped"] = _dropped(ids_i.numpy(), st_.numpy(),
                                              cap, i)
    return out


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 was told to fail")
    return rank


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each port rank's results)."""
    from repro_torch.launch.mesh import launch

    tmp = tmp_path_factory.mktemp("sharding")
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
        ranks = launch(_port_ranks, MESH[0] * MESH[1], (str(inputs),),
                       timeout=TIMEOUT_S)
    finally:
        log, _ = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, log[-4000:]
    return dict(np.load(jax_out)), ranks


def test_launch_reraises_a_rank_failure():
    from repro_torch.launch.mesh import launch
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*told to fail"):
        launch(_fail_on_rank_1, 2, timeout=120)


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            make_production_mesh(multi_pod=multi_pod)


def _rule_names():
    from repro_torch.models.sharding import DEFAULT_RULES
    return sorted(DEFAULT_RULES)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", _rule_names())
def test_logical_to_spec_matches_jax(name, multi_pod):
    """The port's rules against JAX's on the production meshes (an
    ``AbstractMesh``: no devices), for shapes whose dims each axis set
    divides and shapes it does not."""
    from jax.sharding import AbstractMesh, AxisType

    from repro.launch import mesh as jmesh
    from repro.models import sharding as jsharding
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import sharding as tsharding

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    jrules = jmesh.make_rules(AbstractMesh(shape, axes, axis_types=(
        AxisType.Auto,) * len(axes)))
    trules = tmesh.make_rules(tmesh.Mesh(shape, axes))
    assert trules.rules == jrules.rules
    assert trules.spec(name, None) == tuple(jrules.spec(name, None))
    assert tmesh.total_shards(trules) == jmesh.total_shards(jrules)
    assert tmesh.total_shards(trules, name) == jmesh.total_shards(jrules,
                                                                  name)
    for n in (1, 2, 3, 16, 24, 32, 256, 512, 768):
        for names in ((name,), (name, "kv_blocks"), ("act_batch", name)):
            dims = (n,) * len(names)
            assert tsharding.logical_to_spec(trules, *names, shape=dims) == \
                tuple(jsharding.logical_to_spec(jrules, *names, shape=dims))
    assert tsharding.logical_to_spec(None, name) == \
        tuple(jsharding.logical_to_spec(None, name))


def test_mesh_coordinates_and_groups():
    """Row-major coordinates as ``jax.make_mesh`` orders its devices, and
    each axis set's groups by index along it."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert mesh.coords == {"pod": 1, "data": 1, "model": 1}
    assert mesh.axis_index(("data", "model")) == 5
    assert mesh.axis_index(("model", "data")) == 4
    assert mesh._members("model")[0] == [0, 1, 2, 3]
    assert mesh._members(("data", "model"))[1] == list(range(12, 24))
    assert mesh._members(("model", "data"))[0] == [0, 4, 8, 1, 5, 9, 2, 6,
                                                   10, 3, 7, 11]


def test_ranks_are_the_mesh(runs):
    _, ranks = runs
    assert [r["coords"] for r in ranks] == [
        {"data": i, "model": j} for i in range(2) for j in range(2)]


@pytest.mark.parametrize("n", sorted(FINALIZE))
def test_finalize_matches_jax(runs, n):
    """The cross-rank merge over ``n`` ranks against JAX's pmax/psum; the
    rows with no block on some or all ranks included."""
    ref, ranks = runs
    want = ref[f"finalize/{n}"]                 # (n, b, nq, hd), one a shard
    for r in ranks:
        np.testing.assert_allclose(r[f"finalize/{n}"], want[0], **F32_TOL)
    assert np.all(want[0][3] == 0) and np.all(ranks[0][f"finalize/{n}"][3]
                                             == 0)


def _shard_slots(rank, n):
    lo = rank * n // (MESH[0] * MESH[1])
    return slice(lo, lo + n // (MESH[0] * MESH[1]))


def _within_a_bf16_step(got, want):
    """Every entry within one bf16 step at ``want``'s magnitude, or at
    magnitude 1 below it (2^-7): an entry computed from a residual stream
    a bf16 step apart moves by that step times its weights, whatever its
    own size."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
    bad = np.abs(got - want) > step
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


def _hold_pools(got_k, got_v, want_k, want_v, appended, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got_k, want_k, **F32_TOL)
        np.testing.assert_allclose(got_v, want_v, **F32_TOL)
        return
    for got, want in ((got_k, want_k), (got_v, want_v)):
        assert np.array_equal(got[:, ~appended], want[:, ~appended])
        _within_a_bf16_step(got[:, appended], want[:, appended])


def _appended(case, inputs, n):
    """(n, BS) mask of the global (slot, offset) entries the steps wrote."""
    mask = np.zeros((n, BS), bool)
    for t in range(STEPS):
        for r in range(B):
            mask[inputs["aslot"][t][r], inputs["aoff"][t][r]] = True
    return mask


@pytest.fixture(scope="module")
def serve_inputs():
    from repro.configs import get_config
    return {case: _serve_inputs(case, _config(get_config, arch), 100 + i)
            for i, (case, (arch, _, _, _)) in enumerate(SERVE.items())}


@pytest.mark.parametrize("case", list(SERVE))
def test_sharded_serve_step_matches_jax(runs, serve_inputs, case):
    """Four sharded decode steps against JAX's sharded ``serve_step``:
    every rank's logits the same, bit for bit, and held to JAX's; each
    rank's pool shards held to the matching slots of JAX's pools; in
    place, the peer shards unchanged."""
    from test_torch_engine import _check_sampled_logits

    ref, ranks = runs
    _, dtype, inplace, _ = SERVE[case]
    g = serve_inputs[case]
    logs = ranks[0][f"{case}/logits"]
    for r in ranks[1:]:
        assert np.array_equal(r[f"{case}/logits"], logs)
    want = ref[f"{case}/logits"]
    if dtype == "float32":
        np.testing.assert_allclose(logs, want, **F32_TOL)
    else:
        jv, tv = want.reshape(-1, want.shape[-1]), \
            logs.reshape(-1, logs.shape[-1])
        _check_sampled_logits(list(jv), list(tv),
                              KNOWN_NEAR_TIES.get(case, ()))
        flips = [i for i in range(len(jv)) if jv[i].argmax() != tv[i].argmax()]
        assert flips == list(EXACT_TIES.get(case, ())), flips
        for i in flips:
            top2 = np.argsort(-jv[i], kind="stable")[:2]
            assert jv[i][top2[0]] == jv[i][top2[1]]
            assert tv[i].argmax() in top2
    n = g["local_sr"].shape[0]
    appended = _appended(case, g, n)
    for rank, r in enumerate(ranks):
        sl = _shard_slots(rank, n)
        _hold_pools(r[f"{case}/pool_k"], r[f"{case}/pool_v"],
                    ref[f"{case}/pool_k"][:, sl], ref[f"{case}/pool_v"][:, sl],
                    appended[sl], dtype)
        if inplace:
            sp = _shard_slots(rank, g["peer_sr"].shape[0])
            assert np.array_equal(r[f"{case}/peer_k"], g["peer_k"][:, sp])
            assert np.array_equal(ref[f"{case}/peer_k"], g["peer_k"])
    if SERVE[case][0] == "qwen2-moe":
        assert all(r[f"{case}/experts"] == 2 for r in ranks)


@pytest.mark.parametrize("case", list(SERVE))
def test_sharded_serve_step_matches_unsharded(runs, serve_inputs, case):
    """The same steps against the port's own unsharded step: in f32 the
    logits within 1e-5, in bf16 the tokens identical under the near-tie
    guard; the ranks' pool shards together are the unsharded pools."""
    from test_torch_engine import _check_sampled_logits

    _, ranks = runs
    _, dtype, _, _ = SERVE[case]
    g = serve_inputs[case]
    logs, want = ranks[0][f"{case}/logits"], \
        ranks[0][f"{case}/unsharded_logits"]
    if dtype == "float32":
        np.testing.assert_allclose(logs, want, **F32_TOL)
    else:
        _check_sampled_logits(list(want.reshape(-1, want.shape[-1])),
                              list(logs.reshape(-1, logs.shape[-1])))
    n = g["local_sr"].shape[0]
    appended = _appended(case, g, n)
    got_k = np.concatenate([r[f"{case}/pool_k"] for r in ranks], axis=1)
    got_v = np.concatenate([r[f"{case}/pool_v"] for r in ranks], axis=1)
    _hold_pools(got_k, got_v, ranks[0][f"{case}/unsharded_pool_k"],
                ranks[0][f"{case}/unsharded_pool_v"], appended, dtype)
    untouched = ~appended
    assert np.array_equal(got_k[:, untouched], g["local_k"][:, untouched])


@pytest.mark.parametrize("case", list(MOE))
def test_moe_layer_matches_moe_layer_local(runs, case):
    """Expert parallelism against JAX's ``_moe_layer_local``: the same
    dropped (token, expert) pairs (none at capacity factor 8, some at 1),
    the outputs (f32 within 1e-5, bf16 within a bf16 step) and the
    load-balance loss (the sum of the data shards' losses over 2)."""
    ref, ranks = runs
    dtype, cf = MOE[case]
    want_drop = ref[f"moe/{case}/dropped"]
    got_drop = np.concatenate([ranks[i * MESH[1]][f"moe/{case}/dropped"]
                               for i in range(MESH[0])])
    assert np.array_equal(got_drop, want_drop)
    assert (len(want_drop) > 0) == (cf < 8)
    for i in range(MESH[0]):
        assert np.array_equal(ranks[i * MESH[1] + 1][f"moe/{case}/dropped"],
                              ranks[i * MESH[1]][f"moe/{case}/dropped"])
    for r in ranks:
        assert np.array_equal(r[f"moe/{case}/y"], ranks[0][f"moe/{case}/y"])
        np.testing.assert_allclose(r[f"moe/{case}/aux"],
                                   ref[f"moe/{case}/aux"], rtol=1e-6)
    got, want = ranks[0][f"moe/{case}/y"], ref[f"moe/{case}/y"]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        _within_a_bf16_step(got, want)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-reference"]:
    _jax_reference(sys.argv[2], sys.argv[3])
