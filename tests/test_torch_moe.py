"""The port's MoE slice held against the JAX package on reduced qwen2-moe
(2 layers, d 256, 4 experts top-2, one shared expert): the router, the
load-balance loss, the dispatch tables and the combine; the expert FFN
(kernel K7's plain version) against the jitted JAX ``expert_ffn`` in bf16
and the Pallas ``moe_ffn`` in f32; the MoE layer, prefill and one decode
step; and the serving engine, sync and async, against the JAX engine.
The same numpy inputs go to both packages; each test states its
tolerance."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import H100_NVLINK, HarvestRuntime
from repro.kernels.moe_ffn.kernel import moe_ffn as pallas_moe_ffn
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels.moe_ffn import ops as mops
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine
from test_torch_engine import _assert_same_run, _run
from test_torch_model import _map, _pools

# bf16 logits of a 2-layer model: the decode-equivalence tolerance of
# tests/test_decode_equivalence.py (as in tests/test_torch_model.py)
LOGIT_TOL = 0.02
# one bf16 rounding step at magnitude 1
BF16_STEP = 2.0 ** -7
# f32 sums over d and f in another order than the Pallas kernel's
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MiB = 2 ** 20


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-moe").reduced()
    tcfg = t_get_config("qwen2-moe").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _bf16(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(torch.bfloat16)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            TM._layers(tp)[0]["moe"])


# ---------------------------------------------------------------------------
# router, loss, dispatch, combine
# ---------------------------------------------------------------------------


def test_router_topk_matches_jax_with_ties():
    """Identical logits in: identical expert ids, ties included (the lower
    id first), and gate weights and probabilities within one f32 ulp.
    They are not bit-identical because XLA's exp and PyTorch's differ in
    the last bit for some inputs; the division after it matches."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(64, 8)) * 2).astype(np.float32)
    logits[3, 2] = logits[3, 5]                   # a tie inside the top 3
    logits[7, :] = 0.5                            # all eight tied
    logits[9, 1] = logits[9, 6] = logits[9].max() + 1.0   # tie at the top
    jw, ji, jprobs = jax.jit(JMOE.router_topk, static_argnums=1)(
        jnp.asarray(logits), 3)
    tw, ti, tprobs = TMOE.router_topk(torch.from_numpy(logits), 3)
    assert ti.dtype == torch.int32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti[7].tolist() == [0, 1, 2] and ti[9, :2].tolist() == [1, 6]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2.4e-7,
                               atol=0)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=2.4e-7, atol=0)


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(8), size=40).astype(np.float32)
    ids = np.stack([rng.choice(8, 3, replace=False)
                    for _ in range(40)]).astype(np.int32)
    ref = JMOE.load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), 8)
    got = TMOE.load_balance_loss(torch.from_numpy(probs),
                                 torch.from_numpy(ids), 8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def _assignments(seed, t, e, k, skew=False):
    rng = np.random.default_rng(seed)
    p = np.linspace(3.0, 0.2, e) if skew else np.ones(e)
    ids = np.stack([rng.choice(e, k, replace=False, p=p / p.sum())
                    for _ in range(t)]).astype(np.int32)
    w = rng.uniform(0.05, 1.0, size=(t, k)).astype(np.float32)
    return ids, w


@pytest.mark.parametrize("capacity", [40, 5])
def test_build_dispatch_matches_jax(capacity):
    """Identical slot tables, bit for bit; at capacity 5 the skewed
    routing overflows the popular experts and drops assignments."""
    e, k, t = 8, 4, 30
    ids, w = _assignments(2, t, e, k, skew=True)
    jt, jw = jax.jit(JMOE.build_dispatch, static_argnums=(2, 3))(
        jnp.asarray(ids), jnp.asarray(w), e, capacity)
    tt, tw = TMOE.build_dispatch(torch.from_numpy(ids), torch.from_numpy(w),
                                 e, capacity)
    assert tt.dtype == torch.int32 and tw.dtype == torch.float32
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    placed = int((tt.numpy() < t).sum())
    assert placed == t * k if capacity == 40 else placed < t * k


@pytest.mark.parametrize("capacity", [12, 4])
def test_combine_matches_jax_scatter_bit_for_bit(capacity):
    """The bf16 combine, each token's k = 4 products summed in ascending
    slot order, rounds exactly as XLA's CPU scatter-add of the JAX layer
    does (an f32 accumulation would not)."""
    e, k, t, d = 8, 4, 16, 64
    ids, w = _assignments(3, t, e, k, skew=True)
    rng = np.random.default_rng(4)
    out = jnp.asarray(rng.normal(size=(e * capacity, d)), jnp.bfloat16)
    st, sw = JMOE.build_dispatch(jnp.asarray(ids), jnp.asarray(w), e,
                                 capacity)

    @jax.jit
    def combine(out, st, sw):
        y = jnp.zeros((t + 1, d), jnp.bfloat16)
        return y.at[st].add(out * sw[:, None].astype(jnp.bfloat16))[:t]

    ref = np.asarray(combine(out, st, sw), np.float32)
    tst, tsw, order, slot = TMOE._build_dispatch(
        torch.from_numpy(ids), torch.from_numpy(w), e, capacity)
    got = TMOE._combine(_bf16(out), tsw, slot, order, t, k)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_f32(got), ref)


# ---------------------------------------------------------------------------
# expert FFN: K7's plain version
# ---------------------------------------------------------------------------


def _expert_inputs(seed, e, c, d, f, dtype, empty_slots=0):
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=(e, c, d)).astype(np.float32)
    if empty_slots:
        xd[:, -empty_slots:] = 0.0            # unused capacity slots
    ws = {"wi": rng.normal(size=(e, d, f)) / np.sqrt(d),
          "wg": rng.normal(size=(e, d, f)) / np.sqrt(d),
          "wo": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    ws = {n: jnp.asarray(a.astype(np.float32), dtype) for n, a in ws.items()}
    return jnp.asarray(xd, dtype), ws


def test_expert_ffn_bf16_matches_jitted_jax(setup):
    """bf16: within one bf16 rounding step of the jitted JAX expert_ffn
    (the two round where they may differ by a step: XLA fuses some bf16
    intermediates); empty capacity slots give exact zeros."""
    cfg, tcfg, _, _ = setup
    xd, ws = _expert_inputs(5, 4, 8, 256, 256, jnp.bfloat16, empty_slots=2)
    ref = np.asarray(jax.jit(lambda x, p: JMOE.expert_ffn(x, p, cfg))(xd, ws),
                     np.float32)
    got = TMOE.expert_ffn(_bf16(xd), {n: _bf16(a) for n, a in ws.items()},
                          tcfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(_f32(got) - ref).max()
    assert err <= BF16_STEP, err
    assert np.all(_f32(got)[:, -2:] == 0.0)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_expert_ffn_f32_matches_pallas_kernel(activation):
    """f32: the roundings vanish and the plain version computes the Pallas
    kernel's function (run in interpret mode, f_block 128 dividing f)."""
    xd, ws = _expert_inputs(6, 4, 8, 256, 256, jnp.float32)
    ref = np.asarray(pallas_moe_ffn(xd, ws["wi"], ws["wg"], ws["wo"],
                                    activation=activation, f_block=128,
                                    interpret=True))
    got = mops.moe_ffn(*(torch.from_numpy(np.array(a)) for a in
                         (xd, ws["wi"], ws["wg"], ws["wo"])),
                       activation=activation)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


def test_expert_ffn_takes_widths_the_pallas_kernel_refuses():
    """f = 915 (phi-tiny-moe's expert width) is no multiple of the Pallas
    kernel's f_block; the port takes it, and agrees with the oracle in
    f32 (repro.kernels.moe_ffn.ref's einsums)."""
    from repro.kernels.moe_ffn.ref import moe_ffn_ref
    xd, ws = _expert_inputs(7, 3, 5, 96, 915, jnp.float32)
    with pytest.raises(AssertionError):
        pallas_moe_ffn(xd, ws["wi"], ws["wg"], ws["wo"], interpret=True)
    ref = np.asarray(moe_ffn_ref(xd, ws["wi"], ws["wg"], ws["wo"]))
    got = mops.moe_ffn(*(torch.from_numpy(np.array(a)) for a in
                         (xd, ws["wi"], ws["wg"], ws["wo"])))
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


def test_moe_ffn_wrapper_checks_its_operands():
    x = torch.zeros((2, 3, 8))
    w, wo = torch.zeros((2, 8, 5)), torch.zeros((2, 5, 8))
    assert mops.moe_ffn(x, w, w, wo).shape == (2, 3, 8)
    with pytest.raises(ValueError):
        mops.moe_ffn(x, w, w, wo, activation="tanh")
    with pytest.raises(ValueError):
        mops.moe_ffn(x, w[:, :7], w, wo)
    with pytest.raises(ValueError):
        mops.moe_ffn(x, w, w, wo.transpose(1, 2))
    with pytest.raises(TypeError):
        mops.moe_ffn(x.bfloat16(), w, w, wo)
    with pytest.raises(TypeError):
        mops.moe_ffn(x.double(), w.double(), w.double(), wo.double())


# ---------------------------------------------------------------------------
# the MoE layer, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_moe_layer_matches_jax(setup, capacity_factor):
    """The layer in bf16 against the jitted JAX moe_layer: outputs within
    one bf16 rounding step (bit-identical on this input), aux loss within
    1e-6.  The rows lean towards expert 0's router column, so at capacity
    factor 1.25 over 64 rows it overflows and assignments drop."""
    cfg, tcfg, jp, tp = setup
    jl, tl = _layer0(jp, tp)
    r0 = np.asarray(jl["router"][:, 0])
    x = np.random.default_rng(8).normal(size=(2, 32, cfg.d_model))
    x = jnp.asarray(x + 4.0 * r0 / np.linalg.norm(r0), jnp.bfloat16)
    jy, jaux = jax.jit(lambda a, p: JMOE.moe_layer(
        a, p, cfg, capacity_factor=capacity_factor))(x, jl)
    ty, probs, ids = TMOE.moe_layer(_bf16(x), tl, tcfg,
                                    capacity_factor=capacity_factor)
    taux = TMOE.load_balance_loss(probs, ids, tcfg.moe.num_experts)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == jy.shape
    err = np.abs(_f32(ty) - np.asarray(jy, np.float32)).max()
    assert err <= BF16_STEP, err
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    if capacity_factor == 1.25:
        t, e, k = 64, cfg.moe.num_experts, cfg.moe.top_k
        cap = max(int(t * k / e * 1.25), 4)
        logits = torch.einsum("td,de->te", _bf16(x).reshape(t, -1).float(),
                              tl["router"])
        _, ids, _ = TMOE.router_topk(logits, k)
        st, _ = TMOE.build_dispatch(ids, torch.ones(ids.shape), e, cap)
        assert int((st < t).sum()) < t * k       # some choices dropped


def _jit_forward(cfg):
    return jax.jit(lambda p, t, s: JM.forward(
        p, {"tokens": t, "positions": s}, cfg, want_kv=True))


def test_forward_logits_kv_and_aux_match_jax(setup):
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    jl, jo = _jit_forward(cfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, to = TM.forward(tp, {"tokens": torch.from_numpy(toks),
                             "positions": torch.from_numpy(pos)}, tcfg,
                        want_kv=True)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    err = np.abs(_f32(tl) - np.asarray(jl, np.float32)).max()
    assert err < LOGIT_TOL, err
    for jt, tt in zip(jo.kv, to.kv):
        kerr = np.abs(_f32(tt) - np.asarray(jt, np.float32)).max()
        assert kerr < LOGIT_TOL, kerr
    np.testing.assert_allclose(to.aux.item(), float(jo.aux), rtol=1e-5)


def test_serve_step_matches_jax_and_forward(setup):
    """Decode steps over pools filled from prefill: logits against the
    jitted JAX serve_step and against the port's own forward; the MoE
    capacity of a decode step comes from its batch rows alone."""
    cfg, tcfg, jp, tp = setup
    b, s, bs, n_extra = 3, 13, 8, 3
    npb = (s + n_extra + bs - 1) // bs
    rng = np.random.default_rng(10)
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
    jst = JM.DecodeState(tokens=None, pos=None, kv=JM.KVPools(
        *(jnp.asarray(a) for a in (pk, pv, sr, sb)),
        jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32)),
        peer=None, states=None)
    tst = TM.DecodeState(tokens=None, pos=None, peer=None, kv=TM.KVPools(
        *(torch.from_numpy(a.copy()) for a in (pk, pv, sr, sb)),
        torch.zeros((b,), dtype=torch.int32),
        torch.zeros((b,), dtype=torch.int32)))
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
        err = np.abs(_f32(tl) - np.asarray(jl, np.float32)).max()
        assert err < LOGIT_TOL, (t, err)
        ferr = (tl.float() - t_full[:, p].float()).abs().max().item()
        assert ferr < LOGIT_TOL, (t, ferr)
    np.testing.assert_allclose(tst.kv.pool_k.numpy(),
                               np.asarray(jst.kv.pool_k), atol=LOGIT_TOL)


def test_interleaved_moe_still_raises():
    """Llama-4's interleaving (layer_period 2) is served now
    (tests/test_torch_archs.py); any other period, which the JAX package
    refuses too (its schema asserts a period of 2), still raises in the
    params, the model and the engine."""
    cfg = t_get_config("llama4-maverick-400b-a17b")
    assert TM.build_schema(cfg)["blocks"].keys() == {"dense", "moe"}
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           layer_period=3))
    with pytest.raises(NotImplementedError):
        TM.build_schema(cfg)
    with pytest.raises(NotImplementedError):
        TorchEngine(cfg, {}, device="cpu")


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def test_sync_engine_matches_jax(setup):
    cfg, tcfg, jp, tp = setup
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    assert j[0].kv_mgr.stats["evict_to_peer"] > 0
    _assert_same_run(j, t)


def _f32_params(jp, tp):
    """The same weights widened to f32 on both sides (bf16 -> f32 is
    exact)."""
    return (jax.tree.map(lambda a: a.astype(jnp.float32), jp),
            _map(tp, lambda t: t.float()))


def test_async_slo_fidelity_engine_matches_jax(setup):
    """Async clock, per-SLO fidelity, a peer budget of about two int8
    blocks: demotions reach peer and host and come back (K6 gathers each
    evicted block, K5 writes each reload, K2/K3 degrade it; their plain
    versions here).  The weights are widened to f32 on both sides: in bf16
    this run meets a decode step whose JAX top-1/top-2 gap is within two
    bf16 steps while the deciding logits differ by one step (the open
    bf16 rounding difference of ROADMAP C; the tokens still agree), so the
    near-tie guard could not show the token equality is not a coin toss."""
    cfg, tcfg, jp, tp = setup
    jp, tp = _f32_params(jp, tp)
    budget = 17000
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, budget,
             mode="async", fidelity_policy="slo")
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             budget, mode="async", fidelity_policy="slo", device="cpu")
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["evict_to_host"] > 0
    assert kv["reload_peer"] > 0 and kv["reload_host"] > 0
    jfid = j[0].runtime.stats()["fid"]
    assert jfid["demote_int8"] > 0
    assert t[0].runtime.stats()["fid"] == jfid
    _assert_same_run(j, t)


def test_cli_serves_qwen2_moe_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-moe", "--device", "cpu", "--scheduler",
        "fair", "--num-requests", "3", "--max-new-tokens", "4",
        "--fidelity-policy", "slo", "--mode", "async"])
    serve.main()
    assert "3/3 requests served" in capsys.readouterr().out
