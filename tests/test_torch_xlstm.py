"""The ssm family of the port held against the JAX package at the reduced
size: xlstm-1.3b, super-blocks of (``slstm_every`` - 1) mLSTM blocks and
one sLSTM block, no attention and so no KV cache.  Four layers: two
super-blocks of one mLSTM and one sLSTM block (``slstm_every`` is 2 when
reduced).  JAX weights cross with the bridge, the conv bias, the gate
biases and the sLSTM input bias drawn first (they initialise to
constants).  The mLSTM cell is held step by step and chunkwise (chunks
shorter than the sequence, the last one padded), the chunkwise form also
against stepping the cell; then both blocks, the model, decode with its
states, and the serving engine.

Tolerances: f32 within F32_TOL (sums in another order); bf16 logits within
LOGIT_TOL, bf16 outputs of a block within two bf16 steps, the f32 states
of a bf16 run within STATE_TOL."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config
from repro.core import H100_NVLINK, HarvestRuntime
from repro.models import model as JM
from repro.models import params as JP
from repro.models import xlstm as JX
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import xlstm as TX
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine
from test_torch_archs import F32_TOL, MiB, _close, _f32_params
from test_torch_engine import _assert_same_run, _run, _run_variant
from test_torch_model import _leaves, _to_numpy

XLSTM = "xlstm-1.3b"
#: two super-blocks of one mLSTM and one sLSTM block
LAYERS = 4
#: the f32 states of a bf16 run: their inputs differ by bf16 steps; two
#: bf16 steps of an entry, and of an entry of magnitude 1 near zero
STATE_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -7)
#: a bf16 block output: two bf16 steps of the entry's magnitude
BLOCK_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _reduced(get):
    return dataclasses.replace(get(XLSTM).reduced(), num_layers=LAYERS)


@pytest.fixture(scope="module")
def ssm():
    cfg, tcfg = _reduced(get_config), _reduced(t_get_config)
    assert cfg.family == "ssm" and cfg.xlstm.slstm_every == 2
    assert JM.num_kv_layers(cfg) == 0
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(3)
    supers = tree["supers"]
    for blk, name, scale, shift in (("mlstm", "conv_b", 0.5, 0.0),
                                    ("mlstm", "b_gates", 1.0, 2.0),
                                    ("slstm", "b_in", 0.5, 0.0)):
        a = supers[blk][name]
        assert np.unique(np.asarray(a, np.float32)).size == 1
        supers[blk][name] = (rng.normal(size=a.shape) * scale
                             + shift).astype(a.dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    return cfg, tcfg, jp, params_from_numpy(tree, tcfg, "cpu")


def _states_close(got, want, dtype):
    """Every leaf of (MLSTMState, SLSTMState): f32 runs within F32_TOL;
    in a bf16 run the bf16 conv tails within BLOCK_TOL and the f32 states
    within STATE_TOL."""
    got = [t for st in got for t in st]
    want = [t for st in want for t in st]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype), (g.dtype, w.dtype)
        tol = F32_TOL if dtype == "float32" else \
            BLOCK_TOL if g.dtype == torch.bfloat16 else STATE_TOL
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


def _to_torch(tree):
    """JAX arrays (nested NamedTuples) to torch tensors of the same dtype."""
    if isinstance(tree, tuple):
        parts = [_to_torch(t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return torch.from_numpy(np.asarray(tree, np.float32)).to(
        getattr(torch, str(tree.dtype)))


# ---------------------------------------------------------------------------
# schema and bridge
# ---------------------------------------------------------------------------


def test_schema_param_count_and_bridge_match_jax(ssm):
    """Leaf for leaf: shapes, inits and dtypes of the schema (mLSTM leaves
    stacked over (super-block, block), sLSTM leaves over super-blocks);
    ``param_count``; the bridge carries every leaf bit for bit and refuses
    a misshapen one."""
    cfg, tcfg, jp, tp = ssm
    jschema = dict(_leaves(JP.build_schema(cfg)))
    tschema = dict(_leaves(TP.build_schema(tcfg)))
    assert jschema.keys() == tschema.keys()
    for path, jd in jschema.items():
        td = tschema[path]
        assert (td.shape, td.init, td.dtype) == \
            (tuple(jd.shape), jd.init, jd.dtype), path
    assert tschema[("supers", "mlstm", "w_up")].stacked == 2
    assert tschema[("supers", "slstm", "w_in")].stacked == 1
    assert TM.param_count(tp) == JM.param_count(jp)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tflat = dict(_leaves(tp))
    assert jflat.keys() == tflat.keys()
    for path, a in jflat.items():
        back = _to_numpy(tflat[path])
        assert back.dtype == a.dtype and back.shape == a.shape, path
        assert np.array_equal(back.view(np.uint8), a.view(np.uint8)), path
    tree = jax.tree.map(np.asarray, jp)
    sl = tree["supers"]["slstm"]
    bad = dict(tree["supers"], slstm=dict(sl, w_rec=sl["w_rec"][..., 1:]))
    with pytest.raises(ValueError):
        params_from_numpy(dict(tree, supers=bad), tcfg, "cpu")


def test_full_width_param_count():
    """xlstm-1.3b at all 48 layers: 2.05 B parameters in both packages'
    schemas."""
    def count(schema):
        return sum(int(np.prod(pd.shape)) for _, pd in _leaves(schema))

    n = count(TP.build_schema(t_get_config(XLSTM)))
    assert n == count(JP.build_schema(get_config(XLSTM)))
    assert 2.0e9 < n < 2.1e9


# ---------------------------------------------------------------------------
# the mLSTM cell
# ---------------------------------------------------------------------------


def _cell_inputs(rng, b, s, nh, hd):
    q, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.normal(size=(b, s, nh)).astype(np.float32)
    f_raw = (rng.normal(size=(b, s, nh)) + 2.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _cell_state(rng, b, nh, hd, W, d_inner):
    return JX.MLSTMState(
        c=jnp.asarray(rng.normal(size=(b, nh, hd, hd)) * 0.1, jnp.float32),
        n=jnp.asarray(rng.normal(size=(b, nh, hd)) * 0.1, jnp.float32),
        m=jnp.asarray(rng.normal(size=(b, nh)), jnp.float32),
        conv=jnp.asarray(rng.normal(size=(b, W - 1, d_inner)), jnp.bfloat16))


def test_mlstm_step_matches_jax(ssm):
    """One stabilized step of the matrix memory from a given state: h and
    the new (c, n, m) against the jitted JAX step."""
    cfg, _, _, _ = ssm
    d_inner, nh, hd = JX.xlstm_dims(cfg)
    rng = np.random.default_rng(4)
    q, k, v, i_raw, f_raw = (a[:, 0] for a in _cell_inputs(rng, 2, 1, nh,
                                                             hd))
    st = _cell_state(rng, 2, nh, hd, cfg.xlstm.conv_width, d_inner)
    jh, jst = jax.jit(JX.mlstm_step)(*(jnp.asarray(a) for a in (
        q, k, v, i_raw, f_raw)), st)
    th, tst = TX.mlstm_step(*(torch.from_numpy(a) for a in (
        q, k, v, i_raw, f_raw)), _to_torch(st))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    for t, j in zip(tst, jst):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **F32_TOL)


@pytest.mark.parametrize("from_state", [False, True])
def test_mlstm_chunkwise_matches_jax_and_steps(ssm, from_state):
    """40 tokens in chunks of 16 (the last padded with the reference's
    neutral gates), from zero state and from a given one: h and the final
    (c, n, m) against the jitted JAX chunkwise form, and against stepping
    the port's ``mlstm_step`` token by token (the oracle)."""
    cfg, _, _, _ = ssm
    d_inner, nh, hd = JX.xlstm_dims(cfg)
    b, s, chunk = 2, 40, 16
    rng = np.random.default_rng(5)
    arrays = _cell_inputs(rng, b, s, nh, hd)
    st = _cell_state(rng, b, nh, hd, cfg.xlstm.conv_width, d_inner) \
        if from_state else None
    jh, jfinal = jax.jit(lambda *a: JX.mlstm_chunkwise(
        *a, chunk=chunk))(*(jnp.asarray(a) for a in arrays), st)
    tin = [torch.from_numpy(a) for a in arrays]
    tst = _to_torch(st) if from_state else None
    th, tfinal = TX.mlstm_chunkwise(*tin, tst, chunk=chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    for t, j in zip(tfinal, jfinal):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL)
    step = tst if from_state else TX.init_mlstm_state(
        _reduced(t_get_config), b, "cpu")
    hs = []
    for i in range(s):
        h, step = TX.mlstm_step(*(a[:, i] for a in tin), step)
        hs.append(h)
    np.testing.assert_allclose(th.numpy(), torch.stack(hs, 1).numpy(),
                               **F32_TOL)
    for t, o in zip(tfinal, step[:3]):
        np.testing.assert_allclose(t.numpy(), o.numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_matches_jax(ssm, block, single, dtype):
    """``mlstm_block`` and ``slstm_block`` of super-block 0 from a given
    state, over 40 tokens or one: output and new state against the jitted
    JAX block."""
    cfg, tcfg, jp, tp = ssm
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    d_inner, nh, hd = JX.xlstm_dims(cfg)
    rng = np.random.default_rng(6)
    s = 1 if single else 40
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    if block == "mlstm":
        jl = jax.tree.map(lambda t: t[0, 0], jp["supers"]["mlstm"])
        tl = {k: v[0, 0] for k, v in tp["supers"]["mlstm"].items()}
        st = _cell_state(rng, 2, nh, hd, cfg.xlstm.conv_width, d_inner)
        jfn, tfn = JX.mlstm_block, TX.mlstm_block
    else:
        jl = jax.tree.map(lambda t: t[0], jp["supers"]["slstm"])
        tl = {k: v[0] for k, v in tp["supers"]["slstm"].items()}
        shape = (2, cfg.num_heads, cfg.d_model // cfg.num_heads)
        st = JX.SLSTMState(*(jnp.asarray(rng.normal(size=shape) * 0.3,
                                         jnp.float32) for _ in range(4)))
        jfn, tfn = JX.slstm_block, TX.slstm_block
    jy, jst = jax.jit(lambda x, p, st: jfn(x, p, cfg, None, st, single))(
        jnp.asarray(x, jdt), jl, st)
    ty, tst = tfn(torch.from_numpy(x).to(getattr(torch, dtype)), tl, tcfg,
                  _to_torch(st), single)
    assert ty.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        ty.float().numpy(), np.asarray(jy, np.float32),
        **(F32_TOL if dtype == "float32" else BLOCK_TOL))
    for t, j in zip(tst, jst):
        assert str(t.dtype)[6:] == str(j.dtype)
        np.testing.assert_allclose(
            t.float().numpy(), np.asarray(j, np.float32),
            **(F32_TOL if dtype == "float32" else STATE_TOL))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return toks, pos


def _jforward(jp, cfg, toks, pos):
    return jax.jit(lambda p, t, q: JM.forward(
        p, {"tokens": t, "positions": q}, cfg, want_kv=True))(
        jp, jnp.asarray(toks), jnp.asarray(pos))


def _tforward(tp, tcfg, toks, pos):
    return TM.forward(tp, {"tokens": torch.from_numpy(toks),
                           "positions": torch.from_numpy(pos)}, tcfg,
                      want_kv=True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_prefill_match_jax(ssm, dtype):
    """300 tokens, past the mLSTM's 256-token chunk: ``forward``'s logits
    and final states (no KV), and ``prefill``'s last-token logits, against
    the jitted JAX functions."""
    cfg, tcfg, jp, tp = ssm
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    toks, pos = _tokens(cfg, 2, 300, seed=7)
    jl, jo = _jforward(jp, cfg, toks, pos)
    tl, to = _tforward(tp, tcfg, toks, pos)
    assert to.kv is None and jo.kv is None
    _close(tl, jl, dtype)
    m, s = to.states
    assert tuple(m.c.shape[:3]) == (2, 1, 2) and tuple(s.h.shape[:2]) == (2, 2)
    _states_close(to.states, jo.states, dtype)
    jlast, _ = jax.jit(lambda p, t, q: JM.prefill(
        p, {"tokens": t, "positions": q}, cfg))(
        jp, jnp.asarray(toks), jnp.asarray(pos))
    tlast, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks),
                               "positions": torch.from_numpy(pos)}, tcfg)
    _close(tlast, jlast, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_step_matches_jax_and_forward(ssm, dtype):
    """Four decode steps from the states a 29-token prefill left (no
    pools): the logits agree with the jitted JAX serve_step and with the
    port's own forward over the whole sequence, and the states after the
    steps with JAX's."""
    cfg, tcfg, jp, tp = ssm
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    b, s, n_extra = 2, 29, 4
    toks, pos = _tokens(cfg, b, s + n_extra, seed=8)
    _, out = _jforward(jp, cfg, toks[:, :s], pos[:, :s])
    t_full, _ = _tforward(tp, tcfg, toks, pos)
    jstep = jax.jit(lambda p, st: JM.serve_step(p, st, cfg))
    jst = JM.DecodeState(tokens=None, pos=None, kv=None, peer=None,
                         states=out.states)
    tst = TM.DecodeState(tokens=None, pos=None, kv=None, peer=None,
                         states=_to_torch(out.states))
    for t in range(n_extra):
        p = s + t
        jst = jst._replace(tokens=jnp.asarray(toks[:, p]),
                           pos=jnp.full((b,), p, jnp.int32))
        tst = tst._replace(tokens=torch.from_numpy(toks[:, p]),
                           pos=torch.full((b,), p, dtype=torch.int32))
        jl, jst = jstep(jp, jst)
        tl, tst = TM.serve_step(tp, tst, tcfg)
        _close(tl, jl, dtype)
        _close(tl, t_full[:, p].float(), dtype)
    _states_close(tst.states, jst.states, dtype)


def test_prefill_states_absorb_the_pad_tokens(ssm):
    """As for the hybrid family (``test_torch_ssm.py``): the states after
    13 tokens differ from those after the 16 the engine pads them to with
    token 0, and the port's padded states are JAX's."""
    cfg, tcfg, jp, tp = ssm
    jp, tp = _f32_params(jp, tp)
    n, n_pad = 13, 16
    toks, pos = _tokens(cfg, 1, n_pad, seed=9)
    toks[:, n:] = 0
    _, j_n = _jforward(jp, cfg, toks[:, :n], pos[:, :n])
    _, j_pad = _jforward(jp, cfg, toks, pos)
    _, t_pad = _tforward(tp, tcfg, toks, pos)
    _states_close(t_pad.states, j_pad.states, "float32")
    for a, b in zip(j_n.states[1], j_pad.states[1]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-3 * \
            np.abs(np.asarray(b)).max()


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_engine_matches_jax(ssm):
    """The seed-golden ``_run`` workload through both engines with f32
    weights (in bf16 a near tie at sampled step 12 flips a token, ROADMAP
    C): no KV block is
    ever allocated and the recurrent states carry every request;
    identical tokens, stats and clock, every step decided."""
    cfg, tcfg, jp, tp = ssm
    jp, tp = _f32_params(jp, tp)
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    assert j[0].kv_mgr.stats["allocated"] == 0 and t[0].pool_k is None
    _assert_same_run(j, t)
    _states_close(t[0].states, j[0].states, "float32")


def test_engine_chunked_prefill_matches_jax(ssm):
    """Chunked prefill's final chunk writes the request's states (f32
    weights)."""
    cfg, tcfg, jp, tp = ssm
    jp, tp = _f32_params(jp, tp)
    j = _run_variant(JaxEngine, jcore, jp, cfg, "chunked_prefill")
    t = _run_variant(TorchEngine, tcore, tp, tcfg, "chunked_prefill",
                     device="cpu")
    _assert_same_run(j, t)
    _states_close(t[0].states, j[0].states, "float32")


def test_disaggregated_prefill_refused_by_both(ssm):
    """A disaggregated prefill streams KV blocks, which this family does
    not have: both engines refuse it."""
    cfg, tcfg, jp, tp = ssm
    for engine_cls, core, params, kw in ((JaxEngine, jcore, jp, {}),
                                         (TorchEngine, tcore, tp,
                                          dict(device="cpu"))):
        c = cfg if engine_cls is JaxEngine else tcfg
        with pytest.raises(AssertionError, match="paged KV cache"):
            _run_variant(engine_cls, core, params, c, "disaggregated", **kw)
