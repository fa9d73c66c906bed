"""Kernel K4 (prefill attention) held against the JAX package, and the
long-prompt slice it serves.

The port's prefill attention runs here through its plain PyTorch version,
which is what the wrapper takes for CPU tensors; the same numpy inputs go
through the Pallas kernel's wrapper ``mha`` in interpret mode, its oracle
``flash_attention_ref`` and JAX's ``chunked_attention``.  The CUDA kernel
is held against the plain version on the card by
tests/test_torch_kernels_gpu.py.  Last, reduced h2o-danube-3-4b (sliding
window 64) is served by the port's engine and the JAX engine with prompts
longer than the window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import H100_NVLINK, HarvestRuntime
from repro.kernels.flash_attention.ops import mha
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine
from test_torch_engine import _assert_same_run, _record_sampled_logits
from test_torch_moe import _f32_params

# f32 outputs: the tolerance of the JAX kernel tests (test_kernels.py)
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, sq, sk, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
    return q, k, v


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


def _fold(q, k, v):
    """The Pallas kernel's layout: (b * nkv, gq * sq, hd) and
    (b * nkv, sk, hd)."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gq = nq // nkv
    qf = q.reshape(b, sq, nkv, gq, hd).transpose(0, 2, 3, 1, 4).reshape(
        b * nkv, gq * sq, hd)
    kf, vf = (a.transpose(0, 2, 1, 3).reshape(b * nkv, sk, hd)
              for a in (k, v))
    return qf, kf, vf


def _unfold(of, b, sq, nq, nkv, hd):
    gq = nq // nkv
    return np.asarray(of).reshape(b, nkv, gq, sq, hd).transpose(
        0, 3, 1, 2, 4).reshape(b, sq, nq, hd)


def _port(q, k, v, qp, kp, **masks):
    before = fops.prefill_attention.launches
    out = fops.prefill_attention(*(torch.from_numpy(a) for a in
                                   (q, k, v, qp, kp)), **masks)
    assert fops.prefill_attention.launches == before   # the plain version
    return out.numpy()


MASKS = [dict(), dict(sliding_window=5), dict(attention_chunk=8),
         dict(sliding_window=6, attention_chunk=16)]


@pytest.mark.parametrize("masks", MASKS, ids=["causal", "window", "chunk",
                                              "window+chunk"])
@pytest.mark.parametrize("gq,hd", [(1, 32), (4, 120), (8, 64)])
def test_plain_matches_pallas_kernel_and_oracle(gq, hd, masks):
    """sq 24 over sk 24 (two kv heads), the Pallas kernel in interpret mode
    with 8-row blocks, and the materialised-softmax oracle."""
    b, s, nkv = 2, 24, 2
    nq = gq * nkv
    q, k, v = _inputs(gq * 1000 + hd, b, s, s, nq, nkv, hd)
    pos = _positions(b, s)
    got = _port(q, k, v, pos, pos, **masks)
    kern = mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=8,
               kv_block=8, interpret=True, **masks)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    qf, kf, vf = _fold(q, k, v)
    ref = flash_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                              jnp.asarray(vf), sq=s, **masks)
    np.testing.assert_allclose(got, _unfold(ref, b, s, nq, nkv, hd), **TOL)


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("masks", MASKS[:3], ids=["causal", "window",
                                                  "chunk"])
def test_plain_matches_jax_chunked_attention_unpadded(masks, softcap):
    """Where the chunks tile the keys exactly (sk 32 in chunks of 8), JAX's
    ``chunked_attention`` pads nothing and is right; the port agrees with
    it, the logit softcap included (the Pallas kernel has none)."""
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(),
                              sliding_window=masks.get("sliding_window"),
                              attention_chunk=masks.get("attention_chunk"))
    tcfg = dataclasses.replace(t_get_config("h2o-danube-3-4b").reduced(),
                               sliding_window=cfg.sliding_window,
                               attention_chunk=cfg.attention_chunk)
    b, s, nq, nkv, hd = 2, 32, 4, 1, 64
    q, k, v = _inputs(7, b, s, s, nq, nkv, hd)
    pos = _positions(b, s)
    ref = JL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                               cfg, kv_chunk=8, logit_softcap=softcap)
    from repro_torch.models import layers as TL
    got = TL.chunked_attention(*(torch.from_numpy(a) for a in
                                 (q, k, v, pos, pos)), tcfg, kv_chunk=8,
                               logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    wrapped = _port(q, k, v, pos, pos, logit_softcap=softcap, **masks)
    np.testing.assert_allclose(wrapped, np.asarray(ref), **TOL)


def test_plain_takes_positions_not_row_indices():
    """The kernel's function reads positions, not row indices: a query
    block at positions 40..47 over keys at 30..49 is the tail rows of the
    oracle over keys 0..49, and rows of one batch may sit at other
    offsets than another's."""
    b, nq, nkv, hd = 2, 4, 2, 32
    q, k, v = _inputs(3, b, 50, 50, nq, nkv, hd)
    qf, kf, vf = _fold(q, k, v)
    ref = _unfold(flash_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                                      jnp.asarray(vf), sq=50,
                                      sliding_window=10),
                  b, 50, nq, nkv, hd)
    pos = _positions(b, 50)
    got = _port(q[:, 40:48], k[:, 30:50], v[:, 30:50], pos[:, 40:48],
                pos[:, 30:50], sliding_window=10)
    np.testing.assert_allclose(got, ref[:, 40:48], **TOL)


def test_wrapper_checks_its_operands():
    q, k, v = (torch.zeros(s) for s in ((1, 4, 4, 8), (1, 4, 2, 8),
                                        (1, 4, 2, 8)))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fops.prefill_attention(q, k, v[:, :3], pos, pos)
    with pytest.raises(ValueError):
        fops.prefill_attention(q, torch.zeros((1, 4, 3, 8)),
                               torch.zeros((1, 4, 3, 8)), pos, pos)
    with pytest.raises(ValueError):
        fops.prefill_attention(q, k, v, pos[:, :3], pos)


# ---------------------------------------------------------------------------
# the long-prompt slice: reduced h2o-danube-3-4b through both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def danube():
    cfg = get_config("h2o-danube-3-4b").reduced()
    tcfg = t_get_config("h2o-danube-3-4b").reduced()
    assert cfg.sliding_window == tcfg.sliding_window == 64
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _serve_long(engine_cls, runtime_cls, hw, cfg, params, peer_budget, **kw):
    """Four requests with prompts of 70-150 tokens (seeded), 16 new tokens
    each, batch and latency class in turn, two rows at a time over 40
    local slots of 8 tokens; the fair scheduler preempts a request after
    8 decode steps while another waits, which evicts its blocks."""
    runtime = runtime_cls({1: peer_budget}, hardware=hw)
    eng = engine_cls(cfg, params, max_batch=2, block_size=8,
                     num_local_slots=40, max_seq_len=256, runtime=runtime,
                     scheduler="fair", mode="async", fidelity_policy="slo",
                     **kw)
    sampled = _record_sampled_logits(eng)
    rng = np.random.default_rng(0)
    reqs = [eng.submit_request(
        prompt=[int(t) for t in rng.integers(3, 500, size=n)],
        max_new_tokens=16, slo=("batch", "latency")[i % 2])
        for i, n in enumerate(rng.integers(70, 151, size=4))]
    stats = eng.run(max_steps=800)
    return eng, reqs, stats, sampled


def test_long_prompt_danube_engine_matches_jax(danube):
    """Prompts past the window: the window masks prefill (K4's plain
    version) and decode (K1's); preemption evicts blocks to the peer and
    the host (int8 for the batch class) and they come back.  Tokens, kv
    and allocator stats, the clock and the fidelity counters are
    identical, and the sampled logits pass the near-tie guard.  The
    weights are widened to f32 on both sides: in bf16 the same run gives
    identical tokens, stats and clock, but one decode step is a near tie
    (JAX top-1/top-2 gap of one bf16 step) whose deciding logits differ by
    one bf16 step (the open bf16 rounding difference of ROADMAP C), so the
    guard could not show that token equality is no coin toss."""
    cfg, tcfg, jp, tp = danube
    jp, tp = _f32_params(jp, tp)
    budget = 6 * tcore.kv_block_bytes(tcfg, 8)     # six blocks
    j = _serve_long(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, budget)
    t = _serve_long(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK,
                    tcfg, tp, budget, device="cpu")
    assert all(len(r.prompt) > cfg.sliding_window for r in j[1])
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["evict_to_host"] > 0, kv
    assert kv["reload_peer"] > 0 and kv["reload_host"] > 0, kv
    jfid = j[0].runtime.stats()["fid"]
    assert jfid["demote_int8"] > 0, jfid
    assert t[0].runtime.stats()["fid"] == jfid
    _assert_same_run(j, t)
