"""The recurrent layers split by heads over ``model`` (Mamba2's and the
mLSTM's heads, the sLSTM's heads and MLP), held to a numpy reckoning of
each rank's index sets and to the JAX package's sharded gradients.

- each recurrent leaf's index set (``shard_slices`` of
  ``params.leaf_spec``) on every rank of (data 2, model 2) and (data 1,
  model 4) for reduced zamba2-7b and xlstm-1.3b, and on a few ranks of
  the production mesh (16 x 16) at full width (zamba2-7b's 112 heads, 7
  a rank; xlstm-1.3b's 4 heads do not divide 16, so its layers stay
  whole), against the positions reckoned here from ``ssm_dims`` and
  ``xlstm_dims``: Mamba2's ``in_proj`` holds the z and x channels and dt
  entries of the rank's heads and every B and C column, its conv the x
  channels and every B and C channel; the mLSTM's ``w_up`` the xm and z
  columns of its heads.
- ``bridge.shard_train`` then ``gather_train`` (parameters and AdamW
  moments) bit for bit, and ``bridge.shard_decode``'s recurrent leaves and
  states put back together from the four ranks' blocks at the reckoned
  positions bit for bit, in f32 and bf16 on both meshes.
- one training case a family on (1, 4) in f32: ``loss_fn`` and its
  gradients under the default rules (four Mamba2 heads a rank; one mLSTM
  and one sLSTM head a rank), gathered, against ``jax.value_and_grad`` of
  JAX's ``loss_fn`` on the same mesh.  JAX cuts ``in_proj`` into
  contiguous column blocks that straddle z and x; the port's layout
  differs and the gathered gradients are compared whole.  A third case
  widens xlstm-1.3b's sLSTM MLP to 384 columns (its proj factor 1.5),
  which divide over the 4 ranks, so its columns and rows split too (the
  reduced config's 341 stay whole).

The JAX reference runs in one subprocess (this file as a script, 4 host
devices, Auto axes), the port in one launch of 4 gloo ranks, both at
once, as tests/test_torch_recurrent_mesh.py runs them, on its inputs.
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

from test_torch_recurrent_mesh import (F32_REL, XLSTM, ZAMBA, _configs,
                                       _jax_tree, _params_tree, _port_params,
                                       _train_batch)
from test_torch_sharded_train import (_bits, _flatten, _hold_tree,
                                      _sharded_grads, _unflatten)

AXES = ("data", "model")
MESHES = [(2, 2), (1, 4)]
ARCHS = [ZAMBA, XLSTM]
DTYPES = ["float32", "bfloat16"]
#: training held to JAX: case -> (arch, mesh, the sLSTM MLP's proj factor
#: or None for the config's); f32, 4 rows
TRAIN = {"zamba2-1x4": (ZAMBA, (1, 4), None),
         "xlstm-1x4": (XLSTM, (1, 4), None),
         "xlstm-mlp-1x4": (XLSTM, (1, 4), 1.5)}
B = 4
TIMEOUT_S = 300

#: how each recurrent leaf's dims split, by name, counted from its last
#: dim: "fsdp" (d_model over ``data``), "block" (the rank's heads' run of
#: the dim over ``model``), "mlp" (a block where the sLSTM MLP's width
#: divides too), "zxbcdt" and "xbc" (Mamba2's segments), "xz" (the
#: mLSTM's xm and z halves); a leaf not named is whole
SPLITS = {
    "mamba": {"in_proj": {-2: "fsdp", -1: "zxbcdt"}, "conv_w": {-1: "xbc"},
              "conv_b": {-1: "xbc"}, "norm": {-1: "block"},
              "out_proj": {-2: "block", -1: "fsdp"}},
    "mlstm": {"w_up": {-2: "fsdp", -1: "xz"}, "conv_w": {-1: "block"},
              "conv_b": {-1: "block"}, "wq": {-3: "block"},
              "wk": {-3: "block"}, "wv": {-3: "block"},
              "w_gates": {-2: "block"},
              "w_down": {-2: "block", -1: "fsdp"}},
    "slstm": {"w_in": {-4: "fsdp", -3: "block"}, "b_in": {-3: "block"},
              "w_rec": {-4: "block"}, "w_out": {-3: "block", -1: "fsdp"},
              "mlp_wi": {-2: "fsdp", -1: "mlp"},
              "mlp_wg": {-2: "fsdp", -1: "mlp"},
              "mlp_wo": {-2: "mlp", -1: "fsdp"}},
}


def _recurrent_leaves(schema):
    """{(family, name): (path, ParamDef)} of the recurrent layers' leaves."""
    out = {}
    if "mamba_layers" in schema:
        for k, pd in schema["mamba_layers"]["mamba"].items():
            out[("mamba", k)] = (("mamba_layers", "mamba", k), pd)
    if "supers" in schema:
        for fam in ("mlstm", "slstm"):
            for k, pd in schema["supers"][fam].items():
                out[(fam, k)] = (("supers", fam, k), pd)
    return out


def _block(n, size, i):
    k = n // size
    return np.arange(i * k, (i + 1) * k)


def _reckoned(cfg, fam, name, shape, mesh, coords):
    """The positions a rank at ``coords`` of ``mesh`` ({axis: size})
    holds of the leaf ``name`` of ``shape``, one numpy array per dim,
    reckoned from ``ssm_dims`` and ``xlstm_dims``."""
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.models.xlstm import xlstm_dims
    nd, nm = mesh["data"], mesh["model"]
    di, im = coords["data"], coords["model"]
    if fam == "mamba":
        d_inner, nh, _ = ssm_dims(cfg)
        units = [nh]
    else:
        d_inner, nh, _ = xlstm_dims(cfg)
        units = [nh]
        if name.startswith("mlp_"):
            units.append(int(cfg.d_model * cfg.xlstm.proj_factor_slstm))
    heads = all(u % nm == 0 for u in units)
    bc = 2 * cfg.ssm.state_dim if fam == "mamba" else 0
    out = [np.arange(n) for n in shape]
    for dim, kind in SPLITS[fam].get(name, {}).items():
        n = shape[dim]
        if kind == "fsdp":
            if n % nd == 0:
                out[dim] = _block(n, nd, di)
            continue
        if not heads:
            continue
        if kind in ("block", "mlp"):
            out[dim] = _block(n, nm, im)
        elif kind == "xz":
            out[dim] = np.concatenate([_block(d_inner, nm, im),
                                       d_inner + _block(d_inner, nm, im)])
        elif kind == "xbc":
            out[dim] = np.concatenate([_block(d_inner, nm, im),
                                       d_inner + np.arange(bc)])
        elif kind == "zxbcdt":
            out[dim] = np.concatenate([
                _block(d_inner, nm, im), d_inner + _block(d_inner, nm, im),
                2 * d_inner + np.arange(bc),
                2 * d_inner + bc + _block(nh, nm, im)])
    return out


def _as_arrays(index, shape):
    return [np.arange(n)[ix] if isinstance(ix, slice) else np.asarray(ix)
            for ix, n in zip(index, shape)]


def _rules(shape, rank, names=AXES):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import ShardingRules
    return ShardingRules(Mesh(shape, names, rank=rank))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES + [(16, 16)])
def test_leaf_index_sets(arch, shape):
    """Every recurrent leaf's index set on each rank (reduced configs on
    (2, 2) and (1, 4), every rank; full width on the production mesh,
    ranks 0, 17 and 255) against ``_reckoned``; the ranks together hold
    every position of each leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as TP
    from repro_torch.models.sharding import shard_slices
    cfg = get_config(arch) if shape == (16, 16) else _configs(arch)[1]
    mesh = dict(zip(AXES, shape))
    ranks = [0, 17, 255] if shape == (16, 16) else range(shape[0] * shape[1])
    leaves = _recurrent_leaves(TP.build_schema(cfg))
    split = 0
    for (fam, name), (path, pd) in leaves.items():
        covered = None
        for rank in ranks:
            rules = _rules(shape, rank)
            spec = TP.leaf_spec(rules, path, pd)
            got = _as_arrays(shard_slices(rules, spec, pd.shape), pd.shape)
            want = _reckoned(cfg, fam, name, pd.shape, mesh,
                             rules.mesh.coords)
            for d, (g, w) in enumerate(zip(got, want)):
                assert np.array_equal(g, w), (arch, shape, rank, path, d)
            split += any(len(g) < n for g, n in zip(got, pd.shape))
            if shape != (16, 16):
                mark = np.zeros(pd.shape, bool)
                mark[np.ix_(*got)] = True
                covered = mark if covered is None else covered | mark
        assert covered is None or covered.all(), (arch, shape, path)
    assert split > 0
    if arch == XLSTM and shape == (16, 16):     # 4 heads on 16: whole
        rules = _rules(shape, 0)
        for (fam, name), (path, pd) in leaves.items():
            spec = TP.leaf_spec(rules, path, pd)
            assert "model" not in spec, path


# ---------------------------------------------------------------------------
# the JAX reference (this file run as a script, in its own process)
# ---------------------------------------------------------------------------


def _case_configs(case):
    """(JAX config, port config) of a training case."""
    arch, _, factor = TRAIN[case]
    cfgs = _configs(arch)
    if factor is None:
        return cfgs
    return tuple(dataclasses.replace(c, xlstm=dataclasses.replace(
        c.xlstm, proj_factor_slstm=factor)) for c in cfgs)


def _build_inputs(path):
    import jax

    from repro.models import model as JM
    flat = {}
    for arch in ARCHS:
        flat.update(_flatten(jax.tree.map(_bits, _params_tree(arch)),
                             f"{arch}/params/"))
    for i, (case, (arch, _, factor)) in enumerate(TRAIN.items()):
        jcfg = _case_configs(case)[0]
        if factor is not None:
            flat.update(_flatten(jax.tree.map(
                lambda a: _bits(np.asarray(a)),
                JM.init_params(jax.random.PRNGKey(1), jcfg)),
                f"{case}/params/"))
        for k, v in _train_batch(jcfg, B, 700 + i).items():
            flat[f"train/{case}/{k}"] = v
    np.savez(path, **flat)


def _params_key(case):
    arch, _, factor = TRAIN[case]
    return f"{arch}/params/" if factor is None else f"{case}/params/"


def _jax_reference(inputs_path, out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_rules
    from repro.models import model as JM

    inp = dict(np.load(inputs_path))
    out = {}
    for case, (arch, shape, _) in TRAIN.items():
        cfg = _case_configs(case)[0]
        rules = make_rules(jax.make_mesh(
            shape, AXES, axis_types=(jax.sharding.AxisType.Auto,) * 2))
        params = _jax_tree(inp, _params_key(case), "float32")
        batch = {k[len(f"train/{case}/"):]: jnp.asarray(v)
                 for k, v in inp.items() if k.startswith(f"train/{case}/")}
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg: JM.loss_fn(p, b, cfg, rules),
            has_aux=True))(params, batch)
        out.update({f"{case}/grads/{k}": np.asarray(v, np.float32)
                    for k, v in _flatten(grads, "").items()})
        out[f"{case}/nll"] = np.asarray(float(metrics["nll"]))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port (4 gloo ranks)
# ---------------------------------------------------------------------------


def _moments(full, seed):
    """AdamW moments of ``full``'s shapes drawn at random (f32)."""
    from repro_torch.train import optim as O
    g = torch.Generator().manual_seed(seed)
    opt = O.adamw_init(full)
    for t in O.tree_leaves(opt.mu) + O.tree_leaves(opt.nu):
        t.copy_(torch.randn(t.shape, generator=g))
    return opt


def _round_trips(inp, rules):
    """For each family and dtype: whether ``gather_train(shard_train(...))``
    gives back the parameters and moments bit for bit, and this rank's
    ``shard_decode`` blocks of the recurrent leaves and of random states
    (numpy; bf16 as its bits)."""
    from repro_torch.bridge import (gather_train, shard_decode, shard_train,
                                    tensor_to_numpy)
    from repro_torch.models import model as TM
    from repro_torch.train import optim as O
    res = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            cfg, full = _port_params(inp, arch, dtype)
            opt = _moments(full, 5)
            p, o = shard_train(full, opt, cfg, rules)
            pw, ow = gather_train(p, o, cfg, rules, dst=None)
            same = all(torch.equal(a, b) for a, b in zip(
                O.tree_leaves(pw) + O.tree_leaves(ow.mu)
                + O.tree_leaves(ow.nu), O.tree_leaves(full)
                + O.tree_leaves(opt.mu) + O.tree_leaves(opt.nu)))
            g = torch.Generator().manual_seed(9)
            states = [torch.randn(t.shape, generator=g).to(t.dtype)
                      for t in O.tree_leaves(_state_tree(TM.init_states(
                          cfg, B, "cpu")))]
            st = TM.DecodeState(
                tokens=torch.zeros((B,), dtype=torch.int32),
                pos=torch.zeros((B,), dtype=torch.int32), kv=None, peer=None,
                states=_states_like(cfg, states))
            pd, sd = shard_decode(full, st, cfg, rules)
            recurrent = {k: tensor_to_numpy(v) for k, v in
                         _flatten(pd, "").items()
                         if k.startswith(("mamba_layers/mamba/", "supers/"))}
            res[f"{arch}/{dtype}"] = dict(
                train_round_trip=same, decode=recurrent,
                states=[tensor_to_numpy(t) for t in _leaves(sd.states)])
    return res


def _leaves(states):
    if hasattr(states, "_fields"):
        return list(states)
    return [t for st in states for t in st]


def _state_tree(states):
    return {f"{i:02d}": t for i, t in enumerate(_leaves(states))}


def _states_like(cfg, leaves):
    from repro_torch.models import ssm as TS
    from repro_torch.models import xlstm as TX
    if cfg.family == "hybrid":
        return TS.SSMState(*leaves)
    return TX.MLSTMState(*leaves[:4]), TX.SLSTMState(*leaves[4:])


def _port_ranks(rank, world, inputs_path):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import model as TM
    from repro_torch.train import optim as O

    inp = dict(np.load(inputs_path))
    meshes = {shape: make_rules(Mesh(shape, AXES)) for shape in MESHES}
    out = {"coords": {s: r.mesh.coords for s, r in meshes.items()}}
    for shape, rules in meshes.items():
        out[f"trips/{shape}"] = _round_trips(inp, rules)
    from repro_torch.bridge import params_from_numpy, shard_train
    for case, (arch, shape, _) in TRAIN.items():
        cfg = _case_configs(case)[1]
        full = params_from_numpy(_unflatten(
            {k: v.copy() for k, v in inp.items()
             if k.startswith(_params_key(case))}, _params_key(case)), cfg,
            "cpu")
        full = O.tree_unflatten(full, [t.float() for t in O.tree_leaves(full)])
        batch = {k[len(f"train/{case}/"):]: torch.from_numpy(v)
                 for k, v in inp.items() if k.startswith(f"train/{case}/")}
        p, _ = shard_train(full, None, cfg, meshes[shape])
        out[f"train/{case}"] = _sharded_grads(TM, O, p, batch, cfg,
                                              meshes[shape])
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each port rank's results, the inputs)."""
    from repro_torch.launch.mesh import launch

    tmp = tmp_path_factory.mktemp("recurrent_tp")
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_shard_train_gather_train_round_trip(runs, shape, arch, dtype):
    """``gather_train(shard_train(params, moments))`` is the parameters
    and the moments bit for bit on every rank."""
    _, ranks, _ = runs
    assert all(r[f"trips/{shape}"][f"{arch}/{dtype}"]["train_round_trip"]
               for r in ranks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_shard_decode_round_trip(runs, shape, arch, dtype):
    """``shard_decode``: every rank's block of each recurrent leaf, laid
    at its reckoned positions (``_reckoned``, without ``data``: decode
    keeps d_model whole), gives back the whole leaf bit for bit, every
    position held by some rank and the ranks that hold one alike; the
    states likewise from their reckoned rows and heads (the conv tails'
    channels as the leaves': zamba2's x | B C, the mLSTM's block)."""
    from repro_torch.models import params as TP
    from test_torch_recurrent_mesh import _state_cut
    _, ranks, inp = runs
    cfg = _configs(arch)[1]
    whole = {k[len(f"{arch}/params/"):]: v for k, v in inp.items()
             if k.startswith(f"{arch}/params/")}
    if dtype == "float32":
        whole = {k: (v.astype(np.uint32) << 16).view(np.float32)
                 if v.dtype == np.uint16 else v.astype(np.float32)
                 for k, v in whole.items()}
    mesh = dict(zip(AXES, shape))
    leaves = _recurrent_leaves(TP.build_schema(cfg))
    for (fam, name), (path, pd) in leaves.items():
        key = "/".join(path)
        want = whole[key]
        got = np.zeros_like(want)
        seen = np.zeros(want.shape, bool)
        for rank, r in enumerate(ranks):
            coords = dict(r["coords"][shape])
            index = _reckoned(cfg, fam, name, pd.shape,
                              dict(mesh, data=1), dict(coords, data=0))
            block = r[f"trips/{shape}"][f"{arch}/{dtype}"]["decode"][key]
            at = np.ix_(*index)
            assert block.shape == tuple(len(i) for i in index), key
            assert np.array_equal(got[at][seen[at]], block[seen[at]]), key
            got[at], seen[at] = block, True
        assert seen.all() and np.array_equal(got, want), key
    # the states: each rank's the reckoned cut of the whole, which the
    # ranks' blocks cover
    from repro_torch.models import model as TM
    from repro_torch.train import optim as O
    g = torch.Generator().manual_seed(9)
    full = [torch.randn(t.shape, generator=g).to(t.dtype) for t in
            O.tree_leaves(_state_tree(TM.init_states(cfg, B, "cpu")))]
    from repro_torch.bridge import tensor_to_numpy
    for j, t in enumerate(full):
        w = tensor_to_numpy(t)
        for rank, r in enumerate(ranks):
            got = r[f"trips/{shape}"][f"{arch}/{dtype}"]["states"][j]
            assert np.array_equal(got, _state_cut(arch, j, w, rank, shape)), \
                (j, rank)


@pytest.mark.parametrize("case", list(TRAIN))
def test_head_split_gradients_match_jax(runs, case):
    """(1, 4): the nll and every gradient (gathered whole) against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` under the same mesh's
    rules, f32 within ``F32_REL`` of each leaf's largest entry; every
    rank gathers the same gradients.  The widened sLSTM MLP's case splits
    it (asserted from its specs)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import params as TP
    from repro_torch.models.sharding import ShardingRules
    arch, shape, factor = TRAIN[case]
    if arch == XLSTM:
        spec = TP.param_specs(_case_configs(case)[1],
                              ShardingRules(Mesh(shape, AXES, rank=0)))
        assert ("model" in spec["supers"]["slstm"]["mlp_wo"]) \
            == (factor is not None)
    ref, ranks, _ = runs
    metrics, _, grads = ranks[0][f"train/{case}"]
    want = {k[len(f"{case}/grads/"):]: v for k, v in ref.items()
            if k.startswith(f"{case}/grads/")}
    _hold_tree(grads, want, F32_REL, "grads")
    np.testing.assert_allclose(metrics["nll"], float(ref[f"{case}/nll"]),
                               rtol=F32_REL)
    for r in ranks[1:]:
        for k, g in r[f"train/{case}"][2].items():
            assert np.array_equal(g, grads[k]), k


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-reference"]:
    _jax_reference(sys.argv[2], sys.argv[3])
