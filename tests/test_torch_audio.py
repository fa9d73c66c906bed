"""The audio family of the port held against the JAX package at the
reduced size: musicgen-medium, a dense stack of non-gated gelu MLP blocks
over 4 parallel codebooks (each with its own embedding table and head),
sinusoidal positions added to the input stream, and 8 prefix
(conditioning) embeddings ahead of every row.  JAX weights cross with the
bridge.  The codebook sum and the gelu are held bit for bit in bf16, the
sinusoidal table at a tolerance that grows with the position (XLA's f32
``exp`` rounds otherwise than torch's); then forward, prefill, decode
steps whose (b, ncb) tokens must equal JAX's, and the loss and its
gradient.  The serving engine refuses this family, as the JAX engine
cannot serve it (tests/test_torch_model.py)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import params as JP
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from test_torch_archs import F32_TOL, KV_TOL, LOGIT_TOL, _close, _f32_params
from test_torch_model import _leaves, _pools, _to_numpy
from test_torch_train_grads import BF16_GRAD_REL, F32_GRAD_REL, LOSS_TOL

AUDIO = "musicgen-medium"
#: the reduced model's prefix embeddings and codebooks
NPRE, NCB = 8, 4
#: the sinusoidal table, f32, against the jitted JAX table: the
#: frequencies' last bits differ where XLA's ``exp`` rounds otherwise than
#: torch's, and the angle multiplies that by the position; the largest
#: difference over a position's entries
#: stays below this times (1 + position) (measured at full width,
#: positions 0-2,999: 1.19e-7 (1 + p), 2.44e-4 at most)
SINUSOID_REL = 2.0 ** -22


@pytest.fixture(scope="module")
def audio():
    cfg, tcfg = get_config(AUDIO).reduced(), t_get_config(AUDIO).reduced()
    assert cfg.family == "audio" and cfg.rope_style == "none"
    assert cfg.activation == "gelu" and not cfg.gated_mlp
    assert (cfg.modality.num_prefix_embeddings, cfg.modality.num_codebooks) \
        == (NPRE, NCB)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# schema and bridge
# ---------------------------------------------------------------------------


def test_schema_param_count_and_bridge_match_jax(audio):
    """Leaf for leaf: shapes, inits and dtypes of the schema, the codebook
    tables (ncb, V, d) and heads (ncb, d, V) among them; ``param_count``
    reduced and at full width (JAX's ``abstract_params``: 1.0-2.0 B, as
    tests/test_configs.py expects); the bridge carries every leaf both
    ways bit for bit and refuses a table of the wrong codebook count."""
    cfg, tcfg, jp, tp = audio
    jschema = dict(_leaves(JP.build_schema(cfg)))
    tschema = dict(_leaves(TP.build_schema(tcfg)))
    assert jschema.keys() == tschema.keys()
    for path, jd in jschema.items():
        td = tschema[path]
        assert (td.shape, td.init, td.dtype) == \
            (tuple(jd.shape), jd.init, jd.dtype), path
    d, V = cfg.d_model, cfg.vocab_size
    assert tschema[("embed",)].shape == (NCB, V, d)
    assert tschema[("lm_head",)].shape == (NCB, d, V)
    assert "wg" not in tp["layers"]["mlp"]
    assert TM.param_count(tp) == JM.param_count(jp)
    full, tfull = get_config(AUDIO), t_get_config(AUDIO)
    n = TM.param_count(TM.abstract_params(tfull))
    assert n == sum(int(np.prod(a.shape)) for a in
                    jax.tree.leaves(JM.abstract_params(full)))
    assert 1.0e9 < n < 2.0e9, n
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tflat = dict(_leaves(tp))
    back = dict(_leaves(params_to_numpy(tp)))
    assert jflat.keys() == tflat.keys() == back.keys()
    for path, a in jflat.items():
        t = _to_numpy(tflat[path])
        assert t.dtype == a.dtype and t.shape == a.shape, path
        assert np.array_equal(t.view(np.uint8), a.view(np.uint8)), path
        assert np.array_equal(back[path].view(np.uint8), a.view(np.uint8))
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError):
        params_from_numpy(dict(tree, embed=tree["embed"][:-1]), tcfg, "cpu")
    with pytest.raises(ValueError):
        params_from_numpy(dict(tree, lm_head=tree["lm_head"][0]), tcfg,
                          "cpu")


def test_init_params_draws_each_codebook(audio):
    """``init_params`` follows the schema, one codebook's table and head
    at a time, each scaled by its own fan-in as JAX scales it: the table's
    entries by min(0.02, V^-1/2), the head's by min(0.02, d^-1/2)."""
    cfg, tcfg, _, _ = audio
    p = TM.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    assert tuple(p["embed"].shape) == (NCB, cfg.vocab_size, cfg.d_model)
    assert tuple(p["lm_head"].shape) == (NCB, cfg.d_model, cfg.vocab_size)
    for c in range(NCB):
        for name in ("embed", "lm_head"):
            std = p[name][c].float().std().item()
            assert 0.8 * 0.02 < std < 1.2 * 0.02, (name, c, std)
    assert not torch.equal(p["embed"][0], p["embed"][1])


# ---------------------------------------------------------------------------
# embed, sinusoidal positions, gelu
# ---------------------------------------------------------------------------


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s, NCB)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_matches_jax_bit_for_bit(audio, dtype):
    """The codebooks' embeddings summed add by add in codebook order, each
    add rounded in the table's dtype, as the jitted JAX ``sum`` rounds
    them: bit-identical in bf16 and in f32.  One f32 sum rounded once
    differs from it in bf16."""
    cfg, tcfg, jp, tp = audio
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    toks = _tokens(cfg, 2, 300, seed=1)
    want = np.asarray(jax.jit(lambda p, t: JM.embed(p, t, cfg))(
        jp, jnp.asarray(toks)))
    got = TM.embed(tp, torch.from_numpy(toks), tcfg)
    assert tuple(got.shape) == (2, 300, cfg.d_model)
    assert np.array_equal(_to_numpy(got).view(np.uint8), want.view(np.uint8))
    if dtype == "bfloat16":
        once = sum(tp["embed"][c][torch.from_numpy(toks[..., c]).long()]
                   .float() for c in range(NCB)).to(torch.bfloat16)
        assert not torch.equal(once, got)


def test_sinusoidal_positions_match_jax():
    """The f32 table at full width (d 1,536) over positions 0-2,999 (60 s
    of 50 Hz frames): within ``SINUSOID_REL`` (1 + position) of the jitted
    JAX table everywhere, equal at position 0, and sines before cosines.
    Rounded to bf16 it differs from JAX's in a few entries per thousand
    (0.35%), by no more than one bf16 step of an entry near 1 (2^-8)."""
    pos = np.arange(3000, dtype=np.int32)[None]
    want = np.asarray(jax.jit(lambda p: JL.sinusoidal_positions(p, 1536))(
        jnp.asarray(pos)))
    got = TL.sinusoidal_positions(torch.from_numpy(pos), 1536)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 3000, 1536)
    got = got.numpy()
    err = np.abs(got - want).max(-1)[0]
    assert np.all(err <= SINUSOID_REL * (1 + pos[0])), err.max()
    assert np.array_equal(got[0, 0], want[0, 0])
    np.testing.assert_array_equal(got[0, 0, :768], 0.0)
    np.testing.assert_array_equal(got[0, 0, 768:], 1.0)
    gb = got.astype(ml_dtypes.bfloat16).astype(np.float32)
    wb = want.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.abs(gb - wb).max() <= 2.0 ** -8
    assert (gb != wb).mean() < 5e-3


def test_positions_add_like_jax(audio):
    """``add_positions`` on a bf16 stream: the table rounded to bf16 and
    then added in bf16, bit-identical to the jitted JAX add given the same
    table (where one rounding from the f32 sum would differ), over
    positions of the prefix and the tokens alike."""
    cfg, tcfg, _, _ = audio
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    x = x.astype(ml_dtypes.bfloat16)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    table = TL.sinusoidal_positions(torch.from_numpy(pos), cfg.d_model)
    want = np.asarray(jax.jit(lambda a, t: a + t.astype(a.dtype))(
        jnp.asarray(x), jnp.asarray(table.numpy())))
    xt = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    got = TM.add_positions(xt, torch.from_numpy(pos), tcfg)
    assert np.array_equal(_to_numpy(got).view(np.uint8), want.view(np.uint8))
    once = (xt.float() + table).to(torch.bfloat16)
    assert not torch.equal(once, got)


def _all_bf16():
    """Every finite bf16 value at or above 1e-36 in magnitude: XLA on the
    CPU flushes the subnormal results of smaller inputs to zero."""
    x = np.arange(2 ** 16, dtype=np.uint16).view(ml_dtypes.bfloat16)
    f = x.astype(np.float32)
    return x[np.isfinite(f) & (np.abs(f) >= 1e-36)]


def test_gelu_matches_jax_on_every_bf16_input():
    """The port's gelu against the jitted ``jax.nn.gelu`` (its tanh
    approximation) on every bf16 input: bit-identical.  JAX's constants
    are weakly typed and round to bf16 first; multiplying by the f32
    0.044715 instead moves 3 of the 63,402 outputs (and 2,697 of 2^20
    normal draws) by a bf16 step.  In f32 the two tanh differ (XLA's
    is a rational approximation): within 4 f32 ulp of the output, or 2^-20
    where the output is near 0 (u times tanh's error, for |u| up to 12;
    measured: 5.8e-7)."""
    x = _all_bf16()
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    xt = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    got = _to_numpy(TL._gelu(xt))
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    c = torch.tensor((2 / np.pi) ** 0.5, dtype=torch.bfloat16)
    f32_const = xt * (0.5 * (1 + torch.tanh(c * (xt + 0.044715
                                                 * (xt * xt * xt)))))
    assert 0 < int((_to_numpy(f32_const).view(np.uint16)
                    != want.view(np.uint16)).sum()) < 10
    draws = torch.from_numpy(np.random.default_rng(1).normal(
        size=2 ** 20).astype(np.float32)).bfloat16()
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(_to_numpy(draws))))
    assert np.array_equal(_to_numpy(TL._gelu(draws)).view(np.uint16),
                          want.view(np.uint16))
    moved = draws * (0.5 * (1 + torch.tanh(c * (draws + 0.044715 * (
        draws * draws * draws)))))
    assert 2000 < int((_to_numpy(moved).view(np.uint16)
                       != want.view(np.uint16)).sum()) < 3500
    xf = np.random.default_rng(3).normal(size=2 ** 16).astype(np.float32) * 3
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(xf)))
    got = TL._gelu(torch.from_numpy(xf)).numpy()
    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23,
                               atol=2.0 ** -20)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_mlp_matches_jax(audio, dtype):
    """The non-gated gelu MLP on layer 0's weights against the jitted JAX
    MLP: the gelu agrees bit for bit, the two products sum in another
    order, so bf16 outputs differ by a rounding step here and there
    (measured: 10 of 20,480, by 1.2e-4 at most), within ``LOGIT_TOL``;
    f32 within ``F32_TOL``."""
    cfg, tcfg, jp, tp = audio
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    x = np.random.default_rng(4).normal(size=(2, 40, cfg.d_model))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    lp = jax.tree.map(lambda t: t[0], jp["layers"]["mlp"])
    want = jax.jit(lambda a, p: JL.mlp(a, p, cfg))(xj, lp)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = TL.mlp(xt, TM._layers(tp)[0]["mlp"], tcfg)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    else:
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert err.max() < LOGIT_TOL, err.max()


# ---------------------------------------------------------------------------
# forward, prefill, decode, loss
# ---------------------------------------------------------------------------


def _batch(cfg, b, s, seed):
    """(numpy) (b, s, ncb) tokens, positions over the prefix and the
    frames, and random bf16 prefix embeddings (as f32 values)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s, NCB)).astype(np.int32)
    pos = np.broadcast_to(np.arange(NPRE + s, dtype=np.int32),
                          (b, NPRE + s)).copy()
    pre = (0.5 * rng.normal(size=(b, NPRE, cfg.d_model))).astype(np.float32)
    pre = np.asarray(jnp.asarray(pre, jnp.bfloat16), np.float32)
    return toks, pos, pre


def _jax_batch(toks, pos, pre):
    return {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
            "prefix_embeddings": jnp.asarray(pre, jnp.bfloat16)}


def _torch_batch(toks, pos, pre):
    return {"tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos),
            "prefix_embeddings": torch.from_numpy(pre).bfloat16()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_prefill_match_jax(audio, dtype):
    """Prefix embeddings, then 40 frames of 4 codebooks: ``forward``'s
    (b, npre + s, ncb, V) logits and its stacked KV, and ``prefill``'s
    last-position logits, against the jitted JAX functions."""
    cfg, tcfg, jp, tp = audio
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    arrays = _batch(cfg, 2, 40, seed=6)
    jl, jo = jax.jit(lambda p, bt: JM.forward(p, bt, cfg, want_kv=True))(
        jp, _jax_batch(*arrays))
    tl, to = TM.forward(tp, _torch_batch(*arrays), tcfg, want_kv=True)
    assert str(tl.dtype) == f"torch.{dtype}"
    assert tuple(tl.shape) == (2, NPRE + 40, NCB, cfg.vocab_size)
    _close(tl, jl, dtype)
    for jt, tt in zip(jo.kv, to.kv):
        assert tuple(tt.shape[:3]) == (cfg.num_layers, 2, NPRE + 40)
        _close(tt, jt, dtype, kv=True)
    jlast, _ = jax.jit(lambda p, bt: JM.prefill(p, bt, cfg))(
        jp, _jax_batch(*arrays))
    tlast, _ = TM.prefill(tp, _torch_batch(*arrays), tcfg)
    assert tuple(tlast.shape) == (2, NCB, cfg.vocab_size)
    _close(tlast, jlast, dtype)


def test_serve_step_matches_jax_and_forward(audio):
    """Six decode steps from pools that hold a 29-frame prefill's KV, the
    prefix's included (``state.pos`` starts at npre + s): each step's
    (b, ncb, V) logits against the jitted JAX serve_step and against the
    port's own forward over the whole sequence, and the step's argmax
    (b, ncb) tokens equal to JAX's; the steps' k and v land in the pools
    in place, within ``KV_TOL`` of JAX's."""
    cfg, tcfg, jp, tp = audio
    b, s, bs, n_extra = 2, 29, 8, 6
    n = NPRE + s
    npb = (n + n_extra + bs - 1) // bs
    toks, pos, pre = _batch(cfg, b, s + n_extra, seed=7)
    _, out = jax.jit(lambda p, bt: JM.forward(p, bt, cfg, want_kv=True))(
        jp, _jax_batch(toks[:, :s], pos[:, :n], pre))
    pk, pv, sr, sb = _pools(out.kv, n, bs, npb)
    t_full, _ = TM.forward(tp, _torch_batch(toks, pos, pre), tcfg)
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
            kv=jst.kv._replace(append_slot=jnp.asarray(aslot),
                               append_off=jnp.asarray(aoff)))
        tst = tst._replace(
            tokens=torch.from_numpy(toks[:, s + t]),
            pos=torch.full((b,), p, dtype=torch.int32),
            kv=tst.kv._replace(append_slot=torch.from_numpy(aslot),
                               append_off=torch.from_numpy(aoff)))
        jl, jst = jstep(jp, jst)
        tl, tst = TM.serve_step(tp, tst, tcfg)
        assert tst.kv.pool_k is tkv.pool_k        # appended in place
        assert tuple(tl.shape) == (b, NCB, cfg.vocab_size)
        _close(tl, jl, "bfloat16")
        _close(tl, t_full[:, p].float(), "bfloat16")
        assert tuple(tst.tokens.shape) == (b, NCB)
        assert np.array_equal(tst.tokens.numpy(), np.asarray(jst.tokens))
        assert torch.equal(tst.pos, torch.full((b,), p + 1,
                                               dtype=torch.int32))
    np.testing.assert_allclose(tkv.pool_k.numpy(), np.asarray(jst.kv.pool_k),
                               **KV_TOL)
    np.testing.assert_allclose(tkv.pool_v.numpy(), np.asarray(jst.kv.pool_v),
                               **KV_TOL)


def _loss_batch(cfg, seed=8):
    toks, pos, pre = _batch(cfg, 2, 24, seed)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                       # the last frame predicts none
    labels[0, :3, 1] = -1                    # nor do masked codebooks
    return toks, pos, pre, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(audio, dtype):
    """``loss_fn`` with (b, s, ncb) labels (some masked), the prefix
    positions cut off: the loss against JAX's ``loss_fn`` (f32 within
    ``LOSS_TOL``, bf16 within one bf16 step), and the gradient leaf by
    leaf against ``jax.grad`` of it, the codebook tables and heads
    included (f32 within ``F32_GRAD_REL`` of each leaf's largest entry,
    bf16 within ``BF16_GRAD_REL``)."""
    cfg, tcfg, jp, tp = audio
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    toks, pos, pre, labels = _loss_batch(cfg)
    jb = dict(_jax_batch(toks, pos, pre), labels=jnp.asarray(labels))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: JM.loss_fn(p, bt, cfg), has_aux=True))(jp, jb)
    jg = dict(_leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jg)))
    paths, leaves = zip(*_leaves(tp))
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    params = {}
    for path, t in zip(paths, leaves):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    tb = dict(_torch_batch(toks, pos, pre), labels=torch.from_numpy(labels))
    tl, metrics = TM.loss_fn(params, tb, tcfg)
    if dtype == "float32":
        np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    else:
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=2.0 ** -8)
    assert float(metrics["aux"]) == 0.0
    grads = torch.autograd.grad(tl, leaves)
    rel = F32_GRAD_REL if dtype == "float32" else BF16_GRAD_REL
    assert set(jg) == set(paths)
    for path, g in zip(paths, grads):
        r = jg[path]
        assert g.shape == r.shape, path
        err = np.abs(g.float().numpy() - r).max()
        scale = np.abs(r).max()
        assert scale > 0, path
        assert err <= rel * scale, (path, err, scale)
