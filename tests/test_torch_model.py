"""The port's dense decoder held against the JAX package at the reduced
size: parameters cross with the bridge bit for bit, and prefill logits and
one decode step agree with the jitted JAX functions on identical inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

# bf16 logits of a 2-layer model: the decode-equivalence tolerance of
# tests/test_decode_equivalence.py
LOGIT_TOL = 0.02


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("yi-6b").reduced()
    tcfg = t_get_config("yi-6b").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_bridge_round_trips_jax_params_bit_for_bit(setup):
    cfg, tcfg, jp, tp = setup
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tflat = dict(_leaves(tp))
    assert jflat.keys() == tflat.keys()
    for path, arr in jflat.items():
        back = _to_numpy(tflat[path])
        assert back.dtype == arr.dtype and back.shape == arr.shape, path
        assert np.array_equal(back.view(np.uint8), arr.view(np.uint8)), path


def test_bridge_checks_the_schema(setup):
    cfg, tcfg, jp, _ = setup
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError):
        params_from_numpy(bad, tcfg, "cpu")
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                          tcfg, "cpu")


def test_init_params_follows_the_schema_and_the_generator(setup):
    cfg, tcfg, jp, _ = setup
    a = TM.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = TM.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    shapes = {p: (tuple(v.shape), v.dtype.name)
              for p, v in _leaves(jax.tree.map(np.asarray, jp))}
    for path, t in _leaves(a):
        assert (tuple(t.shape), str(t.dtype).split(".")[1]) == shapes[path]
        assert torch.equal(t, dict(_leaves(b))[path])
    # the bridge carries the port's own draws across unchanged too
    again = params_from_numpy(
        {k: v for k, v in _map(a, _to_numpy).items()}, tcfg, "cpu")
    for path, t in _leaves(again):
        assert torch.equal(t, dict(_leaves(a))[path])
    assert TM.param_count(a) == sum(int(np.prod(s)) for s, _ in
                                    shapes.values())


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _jax_flash_ref(q, k, v, cfg):
    """JAX's ``flash_attention_ref`` (the Pallas kernel's oracle) on
    model-layout numpy inputs at positions 0..s-1, folded as ``mha``
    folds them."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gq = nq // nkv
    qf = q.reshape(b, sq, nkv, gq, hd).transpose(0, 2, 3, 1, 4).reshape(
        b * nkv, gq * sq, hd)
    kf, vf = (a.transpose(0, 2, 1, 3).reshape(b * nkv, sk, hd)
              for a in (k, v))
    of = flash_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                             jnp.asarray(vf), sq=sq,
                             sliding_window=cfg.sliding_window,
                             attention_chunk=cfg.attention_chunk)
    return np.asarray(of).reshape(b, nkv, gq, sq, hd).transpose(
        0, 3, 1, 2, 4).reshape(b, sq, nq, hd)


@pytest.mark.parametrize("changes", [{}, {"sliding_window": 6},
                                     {"attention_chunk": 8}])
def test_chunked_attention_matches_jax(changes):
    """kv_chunk 8 pads the 19 keys to 24 and runs the online softmax over
    three chunks.  With a window or an attention chunk the pad keys are
    rejected in both packages, and the port is held to JAX's
    ``chunked_attention``.  Without either, JAX's ``chunked_attention``
    lets the pad keys into the softmax (its fault, see
    test_jax_chunked_attention_pads_its_tail_wrong), so there the port is
    held to ``flash_attention_ref``, the Pallas kernel's oracle."""
    cfg = dataclasses.replace(get_config("yi-6b").reduced(), **changes)
    tcfg = dataclasses.replace(t_get_config("yi-6b").reduced(), **changes)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 19, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 19, 1, 64)).astype(np.float32)
    v = rng.normal(size=(2, 19, 1, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19)).copy()
    if changes:
        ref = np.asarray(JL.chunked_attention(
            *(jnp.asarray(a) for a in (q, k, v, pos, pos)), cfg, kv_chunk=8))
    else:
        ref = _jax_flash_ref(q, k, v, cfg)
    got = TL.chunked_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, pos, pos)), tcfg, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sk,kv_chunk", [(19, 8), (1032, 1024)])
def test_jax_chunked_attention_pads_its_tail_wrong(sk, kv_chunk):
    """JAX's ``chunked_attention`` pads k and v to a multiple of
    ``kv_chunk`` and gives the pad keys position -10**9, which the causal
    mask accepts: every pad key scores 0 and adds to the softmax's
    denominator.  So where sk is no multiple of the chunk, and no window
    or attention chunk rejects the pad keys, it disagrees with
    ``flash_attention_ref``; the port, whose pad keys every mask rejects,
    agrees with the oracle.  sk 1032 is a 1,032-token prompt at the
    default 1024-key chunk."""
    cfg = get_config("yi-6b").reduced()
    tcfg = t_get_config("yi-6b").reduced()
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, sk, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    pos = np.arange(sk, dtype=np.int32)[None]
    ref = _jax_flash_ref(q, k, v, cfg)
    jax_chunked = np.asarray(JL.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), cfg,
        kv_chunk=kv_chunk))
    assert np.abs(jax_chunked - ref).max() > 0.1
    got = TL.chunked_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, pos, pos)), tcfg,
                               kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_mlp_matches_jax(setup, activation):
    """The MLP under each activation, jitted JAX against the port, on the
    reduced yi-6b weights of layer 0."""
    cfg, tcfg, jp, tp = setup
    cfg = dataclasses.replace(cfg, activation=activation)
    tcfg = dataclasses.replace(tcfg, activation=activation)
    x = np.random.default_rng(3).normal(size=(2, 5, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    lp = jax.tree.map(lambda t: t[0], jp["layers"]["mlp"])
    ref = jax.jit(lambda a, p: JL.mlp(a, p, cfg))(xj, lp)
    got = TL.mlp(torch.from_numpy(np.asarray(xj, np.float32)).to(
        torch.bfloat16), TM._layers(tp)[0]["mlp"], tcfg)
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err < LOGIT_TOL, err


def _jit_forward(cfg):
    return jax.jit(lambda p, t, s: JM.forward(
        p, {"tokens": t, "positions": s}, cfg, want_kv=True))


def test_forward_logits_and_kv_match_jax(setup):
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    jl, jo = _jit_forward(cfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, to = TM.forward(tp, {"tokens": torch.from_numpy(toks),
                             "positions": torch.from_numpy(pos)}, tcfg,
                        want_kv=True)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    err = np.abs(tl.float().numpy() - np.asarray(jl, np.float32)).max()
    assert err < LOGIT_TOL, err
    for jt, tt in zip(jo.kv, to.kv):
        kerr = np.abs(tt.float().numpy() - np.asarray(jt, np.float32)).max()
        assert kerr < LOGIT_TOL, kerr


def _pools(kv, s, bs, npb):
    """Pools filled from prefill k/v: request r owns slots r*npb + j."""
    k, v = (np.asarray(t, np.float32) for t in kv)
    L_kv, b, _, nkv, hd = k.shape
    pool_k = np.zeros((L_kv, b * npb, bs, nkv, hd), np.float32)
    pool_v = np.zeros_like(pool_k)
    slot_req = np.full((b * npb,), -1, np.int32)
    slot_base = np.zeros((b * npb,), np.int32)
    for r in range(b):
        for j in range(npb):
            slot = r * npb + j
            slot_req[slot], slot_base[slot] = r, j * bs
            lo, hi = j * bs, min((j + 1) * bs, s)
            if lo < s:
                pool_k[:, slot, :hi - lo] = k[:, r, lo:hi]
                pool_v[:, slot, :hi - lo] = v[:, r, lo:hi]
    return pool_k, pool_v, slot_req, slot_base


def test_serve_step_matches_jax_and_forward(setup):
    """One decode step from identical pools: the port's logits agree with
    the jitted JAX serve_step and with its own full forward, and the step's
    k/v land in the pools in place."""
    cfg, tcfg, jp, tp = setup
    b, s, bs, n_extra = 2, 21, 8, 3
    npb = (s + n_extra + bs - 1) // bs
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + n_extra)).astype(
        np.int32)
    pos = np.broadcast_to(np.arange(s + n_extra, dtype=np.int32),
                          (b, s + n_extra)).copy()
    _, out = _jit_forward(cfg)(jp, jnp.asarray(toks[:, :s]),
                               jnp.asarray(pos[:, :s]))
    pk, pv, sr, sb = _pools(out.kv, s, bs, npb)
    t_full, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks),
                                "positions": torch.from_numpy(pos)}, tcfg)
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
        err = np.abs(tl.float().numpy() - np.asarray(jl, np.float32)).max()
        assert err < LOGIT_TOL, (t, err)
        ferr = (tl.float() - t_full[:, p].float()).abs().max().item()
        assert ferr < LOGIT_TOL, (t, ferr)
    np.testing.assert_allclose(tkv.pool_k.numpy(), np.asarray(jst.kv.pool_k),
                               atol=LOGIT_TOL)


def test_unsupported_families_raise():
    """The audio family (musicgen-medium) is the one the port still
    refuses: in the params, the model and the engine."""
    from repro_torch.serving.engine import HarvestServingEngine
    cfg = t_get_config("musicgen-medium").reduced()
    assert cfg.family == "audio"
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, torch.Generator(), "cpu")
    tokens = torch.zeros((1, 8, cfg.modality.num_codebooks),
                         dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        TM.forward({}, {"tokens": tokens,
                        "positions": torch.arange(8)[None]}, cfg)
    with pytest.raises(NotImplementedError):
        HarvestServingEngine(cfg, {}, device="cpu")
