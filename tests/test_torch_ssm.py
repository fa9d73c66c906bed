"""The hybrid family of the port held against the JAX package at the reduced
size: zamba2-7b, Mamba2 layers with ONE shared attention block after every
``attn_period`` (2 when reduced) of them.  Five layers: two super-blocks
and a one-layer tail, so KV layer 1 and the tail after the last shared
block are exercised; 80 tokens, past the reduced SSD chunk of 32, so the
state carried between chunks is held too.  JAX weights cross with the
bridge, the conv bias, ``dt_bias``, ``A_log`` and ``D`` drawn per channel
and head first (they initialise to constants, which would hide a head or
channel mix-up).  Then the serving engine with its recurrent states,
inline, with chunked prefill and disaggregated.

Tolerances: f32 weights within F32_TOL (sums in another order); bf16
logits within LOGIT_TOL, bf16 KV and conv tails within KV_TOL (the
one-ulp GEMM differences of ROADMAP C reach them through the norms), the
f32 SSM state of a bf16 run within SSM_TOL.  The engine's bf16 run has
three near ties, named (ROADMAP C); its variants run in f32."""
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
from repro.models import ssm as JS
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import ssm as TS
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine
from test_torch_archs import F32_TOL, KV_TOL, MiB, _close, _f32_params
from test_torch_engine import _assert_same_run, _run, _run_variant
from test_torch_model import _leaves, _pools, _to_numpy

ZAMBA = "zamba2-7b"
#: two super-blocks of two Mamba2 layers and the shared block, one tail layer
LAYERS = 5
#: the f32 SSM state of a bf16 run: its inputs differ by the bf16 steps of
#: the residual stream; two bf16 steps of an entry, and 1e-4 for entries
#: near zero (the state's entries reach about 1)
SSM_TOL = dict(rtol=2.0 ** -6, atol=1e-4)
#: the bf16 engine run's sampled steps where JAX's top-1/top-2 gap is at
#: most twice the largest logit difference and the deciding logits differ
#: by a bf16 step (ROADMAP C); the tokens agree there all the same
BF16_NEAR_TIES = [22, 30, 43]


def _reduced(get):
    return dataclasses.replace(get(ZAMBA).reduced(), num_layers=LAYERS)


@pytest.fixture(scope="module")
def hybrid():
    cfg, tcfg = _reduced(get_config), _reduced(t_get_config)
    assert cfg.family == "hybrid" and cfg.hybrid.attn_period == 2
    assert cfg.ssm.chunk_size == 32 and JM.num_kv_layers(cfg) == 2
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(0), cfg))
    mamba = tree["mamba_layers"]["mamba"]
    rng = np.random.default_rng(3)
    for name, scale, shift in (("conv_b", 0.5, 0.0), ("dt_bias", 0.5, -2.0),
                               ("A_log", 0.5, 0.5), ("D", 0.5, 1.0)):
        assert np.unique(np.asarray(mamba[name], np.float32)).size == 1
        mamba[name] = (rng.normal(size=mamba[name].shape) * scale
                       + shift).astype(mamba[name].dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    return cfg, tcfg, jp, params_from_numpy(tree, tcfg, "cpu")


def _state_close(got, want, dtype):
    """Leaf by leaf: f32 states (the SSM state, and conv tails in an f32
    run) within F32_TOL; the bf16 conv tails within KV_TOL, the f32 state
    of a bf16 run within SSM_TOL."""
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        tol = F32_TOL if dtype == "float32" else \
            SSM_TOL if g.ndim == 5 else KV_TOL
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# schema and bridge
# ---------------------------------------------------------------------------


def test_schema_param_count_and_bridge_match_jax(hybrid):
    """Leaf for leaf: shapes, inits and dtypes of the schema (the Mamba2
    stack over all layers, one shared attention block); ``param_count``;
    the bridge carries every leaf bit for bit and refuses a misshapen
    one."""
    cfg, tcfg, jp, tp = hybrid
    jschema = dict(_leaves(JP.build_schema(cfg)))
    tschema = dict(_leaves(TP.build_schema(tcfg)))
    assert jschema.keys() == tschema.keys()
    for path, jd in jschema.items():
        td = tschema[path]
        assert (td.shape, td.init, td.dtype) == \
            (tuple(jd.shape), jd.init, jd.dtype), path
    assert tschema[("mamba_layers", "mamba", "in_proj")].stacked == 1
    assert TM.param_count(tp) == JM.param_count(jp)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tflat = dict(_leaves(tp))
    assert jflat.keys() == tflat.keys()
    for path, a in jflat.items():
        back = _to_numpy(tflat[path])
        assert back.dtype == a.dtype and back.shape == a.shape, path
        assert np.array_equal(back.view(np.uint8), a.view(np.uint8)), path
    tree = jax.tree.map(np.asarray, jp)
    layers = tree["mamba_layers"]
    bad = dict(layers, mamba=dict(layers["mamba"],
                                  conv_w=layers["mamba"]["conv_w"][:, 1:]))
    with pytest.raises(ValueError):
        params_from_numpy(dict(tree, mamba_layers=bad), tcfg, "cpu")


def test_full_width_param_count():
    """zamba2-7b at all 81 layers: 6.75 B parameters in both packages'
    schemas."""
    def count(schema):
        return sum(int(np.prod(pd.shape)) for _, pd in _leaves(schema))

    n = count(TP.build_schema(t_get_config(ZAMBA)))
    assert n == count(JP.build_schema(get_config(ZAMBA)))
    assert 6.7e9 < n < 6.8e9


# ---------------------------------------------------------------------------
# the Mamba2 layer
# ---------------------------------------------------------------------------


def _layer0(jp, tp):
    return (jax.tree.map(lambda t: t[0], jp["mamba_layers"]["mamba"]),
            {k: v[0] for k, v in tp["mamba_layers"]["mamba"].items()})


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(hybrid, with_tail):
    """The depthwise causal conv (4 taps, bias, silu) over 40 bf16 steps,
    from zeros and from a tail: output and new tail within one bf16 step
    of the jitted JAX conv (the tail is a slice: bit for bit)."""
    cfg, tcfg, jp, tp = hybrid
    jl, tl = _layer0(jp, tp)
    _, _, conv_dim = JS.ssm_dims(cfg)
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 40, conv_dim)).astype(np.float32)
    tail = rng.normal(size=(2, 3, conv_dim)).astype(np.float32) \
        if with_tail else None

    def bf(a, lib):
        return None if a is None else (
            jnp.asarray(a, jnp.bfloat16) if lib == "jax"
            else torch.from_numpy(a).bfloat16())

    jy, jt = jax.jit(JS._causal_conv)(bf(u, "jax"), jl["conv_w"],
                                      jl["conv_b"], bf(tail, "jax"))
    ty, tt = TS._causal_conv(bf(u, "torch"), tl["conv_w"], tl["conv_b"],
                             bf(tail, "torch"))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=2.0 ** -8, atol=2.0 ** -9)
    assert np.array_equal(tt.float().numpy(), np.asarray(jt, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["chunked", "chunked_s0", "single"])
def test_mamba2_layer_matches_jax(hybrid, mode, dtype):
    """``mamba2_layer`` over 80 tokens (three SSD chunks, the last padded),
    from zero state and from a given state (``s0`` and a conv tail), and
    the single-token recurrence from a given state: output and new state
    against the jitted JAX layer."""
    cfg, tcfg, jp, tp = hybrid
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    jl, tl = _layer0(jp, tp)
    _, nh, conv_dim = JS.ssm_dims(cfg)
    rng = np.random.default_rng(5)
    s = 1 if mode == "single" else 80
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    st = None
    if mode != "chunked":
        st = (rng.normal(size=(2, nh, cfg.ssm.head_dim, cfg.ssm.state_dim))
              .astype(np.float32) * 1e-2,
              rng.normal(size=(2, 3, conv_dim)).astype(np.float32))
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jst = None if st is None else JS.SSMState(
        jnp.asarray(st[0]), jnp.asarray(st[1], jnp.bfloat16))
    tst = None if st is None else TS.SSMState(
        torch.from_numpy(st[0]), torch.from_numpy(st[1]).bfloat16())
    jy, jnew = jax.jit(lambda x, p, st: JS.mamba2_layer(
        x, p, cfg, None, st, mode == "single"))(jx, jl, jst)
    ty, tnew = TS.mamba2_layer(tx, tl, tcfg, tst, mode == "single")
    assert ty.dtype == tx.dtype and tnew.s.dtype == torch.float32
    assert tnew.conv.dtype == getattr(torch, dtype) \
        or (dtype == "float32" and st is None)
    _close(ty, jy, dtype)
    _state_close(tnew, jnew, dtype)


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
def test_forward_and_prefill_match_jax(hybrid, dtype):
    """80 tokens: ``forward``'s logits, the two super-blocks' stacked KV
    and every layer's final states, and ``prefill``'s last-token logits,
    against the jitted JAX functions."""
    cfg, tcfg, jp, tp = hybrid
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    toks, pos = _tokens(cfg, 2, 80, seed=6)
    jl, jo = _jforward(jp, cfg, toks, pos)
    tl, to = _tforward(tp, tcfg, toks, pos)
    assert tuple(tl.shape) == (2, 80, cfg.vocab_size)
    _close(tl, jl, dtype)
    for jt, tt in zip(jo.kv, to.kv):
        assert tuple(tt.shape[:3]) == (2, 2, 80)
        _close(tt, jt, dtype, kv=True)
    assert isinstance(to.states, TS.SSMState)
    assert tuple(to.states.s.shape[:2]) == (LAYERS, 2)
    _state_close(to.states, jo.states, dtype)
    jlast, _ = jax.jit(lambda p, t, q: JM.prefill(
        p, {"tokens": t, "positions": q}, cfg))(
        jp, jnp.asarray(toks), jnp.asarray(pos))
    tlast, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks),
                               "positions": torch.from_numpy(pos)}, tcfg)
    _close(tlast, jlast, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_step_matches_jax_and_forward(hybrid, dtype):
    """Four decode steps from pools and states that a 29-token prefill
    left: the shared block appends to KV layer 0 and 1 in place, and the
    logits agree with the jitted JAX serve_step and with the port's own
    forward over the whole sequence; the states after the steps agree
    with JAX's."""
    cfg, tcfg, jp, tp = hybrid
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    b, s, bs, n_extra = 2, 29, 8, 4
    npb = (s + n_extra + bs - 1) // bs
    toks, pos = _tokens(cfg, b, s + n_extra, seed=7)
    _, out = _jforward(jp, cfg, toks[:, :s], pos[:, :s])
    pk, pv, sr, sb = _pools(out.kv, s, bs, npb)
    t_full, _ = _tforward(tp, tcfg, toks, pos)
    jstep = jax.jit(lambda p, st: JM.serve_step(p, st, cfg))
    jkv = JM.KVPools(*(jnp.asarray(a) for a in (pk, pv, sr, sb)),
                     jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32))
    tkv = TM.KVPools(*(torch.from_numpy(a.copy()) for a in (pk, pv, sr, sb)),
                     torch.zeros((b,), dtype=torch.int32),
                     torch.zeros((b,), dtype=torch.int32))
    jst = JM.DecodeState(tokens=None, pos=None, kv=jkv, peer=None,
                         states=out.states)
    tst = TM.DecodeState(tokens=None, pos=None, kv=tkv, peer=None,
                         states=TS.SSMState(*(torch.from_numpy(np.asarray(
                             t, np.float32)).to(getattr(torch, str(t.dtype)))
                             for t in out.states)))
    for t in range(n_extra):
        p = s + t
        aslot = np.asarray([r * npb + p // bs for r in range(b)], np.int32)
        aoff = np.full((b,), p % bs, np.int32)
        jst = jst._replace(
            tokens=jnp.asarray(toks[:, p]), pos=jnp.full((b,), p, jnp.int32),
            kv=jst.kv._replace(append_slot=jnp.asarray(aslot),
                               append_off=jnp.asarray(aoff)))
        tst = tst._replace(
            tokens=torch.from_numpy(toks[:, p]),
            pos=torch.full((b,), p, dtype=torch.int32),
            kv=tst.kv._replace(append_slot=torch.from_numpy(aslot),
                               append_off=torch.from_numpy(aoff)))
        jl, jst = jstep(jp, jst)
        tl, tst = TM.serve_step(tp, tst, tcfg)
        assert tst.kv.pool_k is tkv.pool_k        # appended in place
        _close(tl, jl, dtype)
        _close(tl, t_full[:, p].float(), dtype)
    _state_close(tst.states, jst.states, dtype)
    for tt, jt in ((tkv.pool_k, jst.kv.pool_k), (tkv.pool_v, jst.kv.pool_v)):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **(
            F32_TOL if dtype == "float32" else KV_TOL))


def test_prefill_states_absorb_the_pad_tokens(hybrid):
    """The engine's prefill pads a prompt with token 0 to a whole number of
    blocks, and both packages' recurrent states run on through the pads
    (ROADMAP C, reference-side): the states after 13 tokens differ from
    those after the 16 padded ones, and the port's padded states are
    JAX's padded states."""
    cfg, tcfg, jp, tp = hybrid
    jp, tp = _f32_params(jp, tp)
    n, n_pad = 13, 16
    toks, pos = _tokens(cfg, 1, n_pad, seed=8)
    toks[:, n:] = 0
    _, j_n = _jforward(jp, cfg, toks[:, :n], pos[:, :n])
    _, j_pad = _jforward(jp, cfg, toks, pos)
    _, t_pad = _tforward(tp, tcfg, toks, pos)
    _state_close(t_pad.states, j_pad.states, "float32")
    for a, b in zip(j_n.states, j_pad.states):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-3 * \
            np.abs(np.asarray(b)).max()


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_matches_jax(hybrid, dtype):
    """The seed-golden ``_run`` workload (fair scheduler, preemptions and
    their rollback re-prefills) through both engines: identical tokens,
    kv and allocator stats and clock, with evictions to the peer and
    reloads of the shared block's two KV layers; the engine's states
    start with bf16 conv tails in both and come back in the step's dtype.
    In f32 every step is decided; in bf16 the steps ``BF16_NEAR_TIES``
    names are near ties (ROADMAP C)."""
    cfg, tcfg, jp, tp = hybrid
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["reload_peer"] > 0, kv
    assert j[2].preemptions > 0
    _assert_same_run(j, t, BF16_NEAR_TIES if dtype == "bfloat16" else ())
    assert t[0].states.conv.dtype == getattr(torch, dtype)
    _state_close(t[0].states, j[0].states, dtype)


@pytest.mark.parametrize("variant", ["chunked_prefill", "disaggregated"])
def test_engine_variants_match_jax(hybrid, variant):
    """The two other prefill sites that write a request's states: chunked
    prefill's final chunk and the disaggregated prefill's adoption
    (``test_torch_engine.py``'s workloads), f32 weights."""
    cfg, tcfg, jp, tp = hybrid
    jp, tp = _f32_params(jp, tp)
    j = _run_variant(JaxEngine, jcore, jp, cfg, variant)
    t = _run_variant(TorchEngine, tcore, tp, tcfg, variant, device="cpu")
    _assert_same_run(j, t)
    _state_close(t[0].states, j[0].states, "float32")
