"""The vision-language family of the port held against the JAX package at
the reduced size: qwen2-vl-72b, a dense stack with a qkv bias, M-RoPE
(three rotary sections, t, h and w, of (16, 8, 8) frequency slots) and 8
prefix embeddings (the vision frontend's patches, precomputed) ahead of
every prompt.  JAX weights cross with the bridge, the biases drawn nonzero
first (they initialise to zeros, which would hide a missing add).  The
model is held with distinct (t, h, w) ids, a grid of patches over the
prefix, since the engine gives all three the same position, where M-RoPE
equals RoPE and a wrong section order would not show.  Then the serving
engine, inline, with chunked prefill and disaggregated, and the prefix
cache that both engines refuse for such a model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config
from repro.core import H100_NVLINK, HarvestRuntime
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import params as JP
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine
from test_torch_archs import F32_TOL, KV_TOL, MiB, _close, _f32_params
from test_torch_engine import _assert_same_run, _run, _run_variant
from test_torch_model import _leaves, _pools, _to_numpy

VLM = "qwen2-vl-72b"
#: the reduced model's prefix embeddings
NPRE = 8


@pytest.fixture(scope="module")
def vlm():
    cfg, tcfg = get_config(VLM).reduced(), t_get_config(VLM).reduced()
    assert cfg.attn_bias and cfg.rope_style == "mrope"
    assert cfg.modality.num_prefix_embeddings == NPRE
    assert cfg.modality.mrope_sections == (16, 8, 8)
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(0), cfg))
    attn = tree["layers"]["attn"]
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        assert not attn[name].any()
        attn[name] = (rng.normal(size=attn[name].shape) * 0.5).astype(
            attn[name].dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    return cfg, tcfg, jp, params_from_numpy(tree, tcfg, "cpu")


def _positions_3d(b, s, cols=4):
    """(b, NPRE + s, 3) ids: the prefix a grid of patches at t 0 (h its
    row, w its column), then text whose t, h and w differ too, so that
    each section turns at its own rate."""
    p3 = np.zeros((b, NPRE + s, 3), np.int32)
    i = np.arange(NPRE)
    p3[:, :NPRE] = np.stack([0 * i, i // cols, i % cols], -1)
    j = np.arange(s)
    p3[:, NPRE:] = np.stack([2 + j, 5 + 2 * j, 3 + 3 * j], -1)
    return p3


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,hd", [((16, 8, 8), 64),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd):
    """The reduced sections and the full model's, at distinct (t, h, w):
    equal to the jitted JAX ``apply_mrope`` at f32 tolerance, and far
    outside it from what the ids in another order, or RoPE over t alone,
    give."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, NPRE + 24, 4, hd)).astype(np.float32)
    p3 = _positions_3d(2, 24)
    want = np.asarray(jax.jit(lambda a, p: JL.apply_mrope(
        a, p, 1e6, sections))(jnp.asarray(x), jnp.asarray(p3)))
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6,
                         sections).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    swapped = TL.apply_mrope(torch.from_numpy(x),
                             torch.from_numpy(p3[..., ::-1].copy()), 1e6,
                             sections).numpy()
    t_only = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(p3[..., 0]),
                           1e6).numpy()
    # h and w own the slow frequencies: at these ids they move the result
    # by hundreds of times the tolerance, not more
    assert np.abs(swapped - want).max() > 1e-2
    assert np.abs(t_only - want).max() > 1e-2


@pytest.mark.parametrize("grid", [False, True])
def test_position_embedding_matches_jax(vlm, grid):
    """``position_embedding`` of the vlm config: given (t, h, w) ids, and
    without them (text: the three sections share the position, which is
    RoPE exactly)."""
    cfg, tcfg, _, _ = vlm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, NPRE + 16, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(NPRE + 16, dtype=np.int32),
                          (2, NPRE + 16)).copy()
    p3 = _positions_3d(2, 16) if grid else None
    want = np.asarray(jax.jit(lambda a, p, q: JL.position_embedding(
        a, p, cfg, q))(jnp.asarray(x), jnp.asarray(pos),
                       None if p3 is None else jnp.asarray(p3)))
    got = TL.position_embedding(
        torch.from_numpy(x), torch.from_numpy(pos), tcfg,
        None if p3 is None else torch.from_numpy(p3)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    if not grid:
        rope = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             tcfg.rope_theta).numpy()
        assert np.array_equal(got, rope)


# ---------------------------------------------------------------------------
# schema, bridge, forward, prefill, decode
# ---------------------------------------------------------------------------


def test_schema_param_count_and_bridge_match_jax(vlm):
    """Leaf for leaf: shapes, inits and dtypes of the schema, the bias
    leaves among them; ``param_count``; the bridge carries every leaf, the
    nonzero biases too, bit for bit, and refuses a misshapen or missing
    bias."""
    cfg, tcfg, jp, tp = vlm
    jschema = dict(_leaves(JP.build_schema(cfg)))
    tschema = dict(_leaves(TP.build_schema(tcfg)))
    assert jschema.keys() == tschema.keys()
    for path, jd in jschema.items():
        td = tschema[path]
        assert (td.shape, td.init, td.dtype) == \
            (tuple(jd.shape), jd.init, jd.dtype), path
    L, nq, nkv, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    assert [tschema[("layers", "attn", b)].shape for b in ("bq", "bk", "bv")] \
        == [(L, nq, hd), (L, nkv, hd), (L, nkv, hd)]
    assert TM.param_count(tp) == JM.param_count(jp)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tflat = dict(_leaves(tp))
    assert jflat.keys() == tflat.keys()
    for path, a in jflat.items():
        back = _to_numpy(tflat[path])
        assert back.dtype == a.dtype and back.shape == a.shape, path
        assert np.array_equal(back.view(np.uint8), a.view(np.uint8)), path
    tree = jax.tree.map(np.asarray, jp)
    layers, attn = tree["layers"], tree["layers"]["attn"]
    bad = dict(layers, attn=dict(attn, bk=attn["bk"][:, :, :1]))
    with pytest.raises(ValueError):
        params_from_numpy(dict(tree, layers=bad), tcfg, "cpu")
    less = dict(layers, attn={k: v for k, v in attn.items() if k != "bv"})
    with pytest.raises(KeyError):
        params_from_numpy(dict(tree, layers=less), tcfg, "cpu")


def _batch(cfg, b, s, seed):
    """(numpy) tokens, positions over the prefix and the text, random bf16
    prefix embeddings (as f32 values) and the grid's (t, h, w) ids."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(NPRE + s, dtype=np.int32),
                          (b, NPRE + s)).copy()
    pre = rng.normal(size=(b, NPRE, cfg.d_model)).astype(np.float32)
    pre = np.asarray(jnp.asarray(pre, jnp.bfloat16), np.float32)
    return toks, pos, pre, _positions_3d(b, s)


def _jax_batch(toks, pos, pre, p3):
    return {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
            "prefix_embeddings": jnp.asarray(pre, jnp.bfloat16),
            "positions_3d": jnp.asarray(p3)}


def _torch_batch(toks, pos, pre, p3):
    return {"tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos),
            "prefix_embeddings": torch.from_numpy(pre).bfloat16(),
            "positions_3d": torch.from_numpy(p3)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_prefill_match_jax(vlm, dtype):
    """Random prefix embeddings and the grid's ids: ``forward``'s logits
    over prefix and text and its stacked KV, and ``prefill``'s last-token
    logits, against the jitted JAX functions."""
    cfg, tcfg, jp, tp = vlm
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    arrays = _batch(cfg, 2, 24, seed=6)
    jl, jo = jax.jit(lambda p, bt: JM.forward(p, bt, cfg, want_kv=True))(
        jp, _jax_batch(*arrays))
    tl, to = TM.forward(tp, _torch_batch(*arrays), tcfg, want_kv=True)
    assert str(tl.dtype) == f"torch.{dtype}"
    assert tuple(tl.shape) == (2, NPRE + 24, cfg.vocab_size)
    _close(tl, jl, dtype)
    for jt, tt in zip(jo.kv, to.kv):
        assert tuple(tt.shape[:3]) == (cfg.num_layers, 2, NPRE + 24)
        _close(tt, jt, dtype, kv=True)
    jlast, _ = jax.jit(lambda p, bt: JM.prefill(p, bt, cfg))(
        jp, _jax_batch(*arrays))
    tlast, _ = TM.prefill(tp, _torch_batch(*arrays), tcfg)
    _close(tlast, jlast, dtype)


def test_serve_step_matches_jax_and_forward(vlm):
    """Four decode steps from pools that hold a 29-token prefill's KV,
    the prefix's included, each step at its own distinct (t, h, w): the
    port's logits against the jitted JAX serve_step and against its own
    forward over the whole sequence; the steps' k and v land in the pools
    in place."""
    cfg, tcfg, jp, tp = vlm
    b, s, bs, n_extra = 2, 29, 8, 4
    n = NPRE + s
    npb = (n + n_extra + bs - 1) // bs
    toks, pos, pre, p3 = _batch(cfg, b, s + n_extra, seed=7)
    _, out = jax.jit(lambda p, bt: JM.forward(p, bt, cfg, want_kv=True))(
        jp, _jax_batch(toks[:, :s], pos[:, :n], pre, p3[:, :n]))
    pk, pv, sr, sb = _pools(out.kv, n, bs, npb)
    t_full, _ = TM.forward(tp, _torch_batch(toks, pos, pre, p3), tcfg)
    jstep = jax.jit(lambda p, st: JM.serve_step(p, st, cfg))
    jkv = JM.KVPools(*(jnp.asarray(a) for a in (pk, pv, sr, sb)),
                     jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32))
    tkv = TM.KVPools(*(torch.from_numpy(a.copy()) for a in (pk, pv, sr, sb)),
                     torch.zeros((b,), dtype=torch.int32),
                     torch.zeros((b,), dtype=torch.int32))
    jst = JM.DecodeState(tokens=None, pos=None, kv=jkv, peer=None,
                         states=None)
    tst = TM.DecodeState(tokens=None, pos=None, kv=tkv, peer=None)
    for t in range(n_extra):
        p = n + t
        aslot = np.asarray([r * npb + p // bs for r in range(b)], np.int32)
        aoff = np.full((b,), p % bs, np.int32)
        jst = jst._replace(
            tokens=jnp.asarray(toks[:, s + t]),
            pos=jnp.full((b,), p, jnp.int32),
            positions_3d=jnp.asarray(p3[:, p]),
            kv=jst.kv._replace(append_slot=jnp.asarray(aslot),
                               append_off=jnp.asarray(aoff)))
        tst = tst._replace(
            tokens=torch.from_numpy(toks[:, s + t]),
            pos=torch.full((b,), p, dtype=torch.int32),
            positions_3d=torch.from_numpy(p3[:, p].copy()),
            kv=tst.kv._replace(append_slot=torch.from_numpy(aslot),
                               append_off=torch.from_numpy(aoff)))
        jl, jst = jstep(jp, jst)
        tl, tst = TM.serve_step(tp, tst, tcfg)
        assert tst.kv.pool_k is tkv.pool_k        # appended in place
        _close(tl, jl, "bfloat16")
        _close(tl, t_full[:, p].float(), "bfloat16")
    np.testing.assert_allclose(tkv.pool_k.numpy(), np.asarray(jst.kv.pool_k),
                               **KV_TOL)
    np.testing.assert_allclose(tkv.pool_v.numpy(), np.asarray(jst.kv.pool_v),
                               **KV_TOL)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_matches_jax(vlm, dtype):
    """The seed-golden ``_run`` workload through both engines, every
    prefill behind the 8 zero prefix embeddings: identical tokens, kv and
    allocator stats and clock, under the near-tie guard (no step is a
    near tie), with evictions to the peer and reloads."""
    cfg, tcfg, jp, tp = vlm
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["reload_peer"] > 0, kv
    _assert_same_run(j, t)


@pytest.mark.parametrize("variant", ["chunked_prefill", "disaggregated"])
def test_engine_variants_match_jax(vlm, variant):
    """The other two prefill sites that drop the prefix's KV and sample
    past it: chunked prefill's final chunk and the disaggregated
    prefill's streamed KV (``test_torch_engine.py``'s workloads)."""
    cfg, tcfg, jp, tp = vlm
    j = _run_variant(JaxEngine, jcore, jp, cfg, variant)
    t = _run_variant(TorchEngine, tcore, tp, tcfg, variant, device="cpu")
    _assert_same_run(j, t)


def test_prefix_cache_refuses_prefix_embeddings(vlm):
    """The prefix cache keys blocks by their tokens, which do not name a
    prefix of embeddings: both engines refuse it for this model."""
    cfg, tcfg, jp, tp = vlm
    for engine_cls, core, c, params, kw in (
            (JaxEngine, jcore, cfg, jp, {}),
            (TorchEngine, tcore, tcfg, tp, dict(device="cpu"))):
        with pytest.raises(AssertionError, match="prefix-embedding"):
            engine_cls(c, params, max_batch=2, block_size=8,
                       num_local_slots=10, max_seq_len=96,
                       runtime=core.HarvestRuntime({1: 64 * MiB}),
                       prefix_cache=True, **kw)
