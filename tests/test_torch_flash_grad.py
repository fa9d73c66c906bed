"""The gradient of prefill attention (kernel K4's backward) held against
the JAX package on the CPU.

The JAX package has no backward kernel: its loss differentiates
``layers.chunked_attention`` with XLA.  Here the same numpy inputs go
through ``jax.vjp`` of ``chunked_attention`` and of the Pallas kernel's
oracle ``flash_attention_ref``, and through the port's
``PrefillAttention`` (the autograd Function that ``prefill_attention``
takes when its operands require grad; on the CPU its forward and backward
are the plain versions) and its plain backward
``prefill_attention_bwd_plain``.  The CUDA kernels are held against the
plain backward on the card by tests/test_torch_kernels_gpu.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops as fops

# f32: sums in another order than XLA's
TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 gradients: each side rounds its f32 sums to bf16 at other places
# (XLA rounds p and the products' outputs; the port's backward rounds
# once), so entries differ by up to two bf16 steps of their magnitude
# (one step is 2^-7 relative; measured: one step, up to 0.0625 at 12),
# and an entry near 0 that sums terms of magnitude 2-4 by up to 0.021
BF16_TOL = dict(rtol=1.6e-2, atol=3e-2)

MASKS = [dict(), dict(sliding_window=5), dict(attention_chunk=8),
         dict(logit_softcap=2.0),
         dict(sliding_window=6, attention_chunk=16, logit_softcap=5.0)]
MASK_IDS = ["causal", "window", "chunk", "softcap", "all"]


def _inputs(seed, b, s, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, s, nq, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return q, k, v, do, pos


def _cfg(masks):
    return dataclasses.replace(get_config("h2o-danube-3-4b").reduced(),
                               sliding_window=masks.get("sliding_window"),
                               attention_chunk=masks.get("attention_chunk"))


def _jax_vjp(q, k, v, do, pos, masks, dtype, kv_chunk=8):
    """jax.vjp of ``chunked_attention`` (its chunks tile the keys, so it
    pads nothing) at cotangent ``do``."""
    cfg = _cfg(masks)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jpos = jnp.asarray(pos)
    fn = lambda a, b_, c: JL.chunked_attention(  # noqa: E731
        a, b_, c, jpos, jpos, cfg, kv_chunk=kv_chunk,
        logit_softcap=masks.get("logit_softcap"))
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, jd) for a in (q, k, v)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jd))]


def _port_grads(q, k, v, do, pos, masks, dtype):
    """The port's ``prefill_attention`` through ``torch.autograd``: the
    Function on CPU tensors."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    before = fops.prefill_attention.launches, \
        fops.prefill_attention_bwd.launches
    out = fops.prefill_attention(*leaves, tpos, tpos, **masks)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "PrefillAttentionBackward"
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(do).to(dtype))
    # the plain versions on the CPU: no kernel launched
    assert (fops.prefill_attention.launches,
            fops.prefill_attention_bwd.launches) == before
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("gq,hd", [(1, 64), (4, 120), (8, 128), (2, 112)])
def test_function_matches_jax_vjp_f32(gq, hd, masks):
    """f32, 32 tokens (kv_chunk 8: four chunks), two kv heads: the
    Function's gradient against ``jax.vjp`` of ``chunked_attention``."""
    q, k, v, do, pos = _inputs(gq * 100 + hd, 2, 32, 2 * gq, 2, hd)
    ref = _jax_vjp(q, k, v, do, pos, masks, torch.float32)
    got = _port_grads(q, k, v, do, pos, masks, torch.float32)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("masks", MASKS[:3], ids=MASK_IDS[:3])
@pytest.mark.parametrize("gq,hd", [(1, 64), (4, 120), (8, 128)])
def test_function_matches_jax_vjp_bf16(gq, hd, masks):
    """bf16 operands and cotangent: the Function's bf16 gradients against
    ``jax.vjp`` of ``chunked_attention`` in bf16 (``BF16_TOL``)."""
    q, k, v, do, pos = _inputs(gq * 100 + hd + 1, 2, 32, 2 * gq, 2, hd)
    ref = _jax_vjp(q, k, v, do, pos, masks, torch.bfloat16)
    got = _port_grads(q, k, v, do, pos, masks, torch.bfloat16)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, err_msg=f"d{name}", **BF16_TOL)


def _fold(a, b, s, n, hd):
    return a.transpose(0, 2, 1, 3).reshape(b * n, s, hd)


@pytest.mark.parametrize("masks", MASKS[:3], ids=MASK_IDS[:3])
@pytest.mark.parametrize("gq,hd", [(1, 64), (4, 120)])
def test_function_matches_jax_vjp_of_the_kernel_oracle(gq, hd, masks):
    """Against ``jax.vjp`` of ``flash_attention_ref``, the Pallas kernel's
    materialised-softmax oracle, at 19 tokens (no chunk tiles them): MHA
    over ``gq`` q heads per kv head, each q head folded with its kv head
    as ``mha`` folds them."""
    b, s, nkv = 2, 19, 2
    nq = gq * nkv
    q, k, v, do, pos = _inputs(gq + hd, b, s, nq, nkv, hd)
    got = _port_grads(q, k, v, do, pos, masks, torch.float32)

    def oracle(qf, kf, vf):
        # (b * nkv, gq * s, hd) rows of one kv head's q heads
        return flash_attention_ref(qf, kf, vf, sq=s, **masks)

    def fold_q(a):
        return a.reshape(b, s, nkv, gq, hd).transpose(0, 2, 3, 1, 4).reshape(
            b * nkv, gq * s, hd)

    out, vjp = jax.vjp(oracle, jnp.asarray(fold_q(q)),
                       jnp.asarray(_fold(k, b, s, nkv, hd)),
                       jnp.asarray(_fold(v, b, s, nkv, hd)))
    dq, dk, dv = (np.asarray(g) for g in vjp(jnp.asarray(fold_q(do))))
    dq = dq.reshape(b, nkv, gq, s, hd).transpose(0, 3, 1, 2, 4).reshape(
        b, s, nq, hd)
    dk, dv = (a.reshape(b, nkv, s, hd).transpose(0, 2, 1, 3)
              for a in (dk, dv))
    for name, g, r in zip("qkv", got, (dq, dk, dv)):
        np.testing.assert_allclose(g, r, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
def test_plain_bwd_matches_autograd_of_plain_forward(masks, dtype):
    """``prefill_attention_bwd_plain`` against ``torch.autograd`` through
    ``prefill_attention_plain``'s online softmax, at 37 tokens over
    kv_chunk 8 (the last chunk padded at ``PAD_POSITION``), gq 3, hd 48.
    In bf16 autograd differentiates the forward's rounding of p, which the
    backward does not repeat (``BF16_TOL``)."""
    q, k, v, do, pos = _inputs(5, 2, 37, 6, 2, 48)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]
    tpos = torch.from_numpy(pos)
    leaves = [a.clone().requires_grad_() for a in t[:3]]
    out = fops.prefill_attention_plain(*leaves, tpos, tpos, kv_chunk=8,
                                       **masks)
    ref = torch.autograd.grad(out, leaves, t[3])
    o, lse = fops.prefill_attention_plain(*t[:3], tpos, tpos, kv_chunk=8,
                                          return_lse=True, **masks)
    got = fops.prefill_attention_bwd_plain(*t[:3], o, lse, t[3], tpos, tpos,
                                           kv_chunk=8, **masks)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), r.float().numpy(),
                                   err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("masks", MASKS, ids=MASK_IDS)
def test_plain_lse_is_the_masked_logsumexp(masks):
    """The plain forward's LSE, ``m + log(l)``, equals the logsumexp of
    the masked (and capped) scores in f64; a row with no allowed key (a
    query before every key) has LSE ``NEG_INF + log(1e-30)``, which
    rounds to ``NEG_INF`` in f32."""
    q, k, v, _, pos = _inputs(9, 2, 30, 4, 2, 16)
    kpos = pos + 3                     # queries 0..2 see no key
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = fops.prefill_attention_plain(
        tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(kpos),
        kv_chunk=8, return_lse=True, **masks)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 4, 30)
    qs = (tq * torch.tensor(16 ** -0.5)).double().reshape(2, 30, 2, 2, 16)
    s = torch.einsum("bqKgh,bcKh->bKgqc", qs, tk.double())
    if masks.get("logit_softcap"):
        c = masks["logit_softcap"]
        s = c * torch.tanh(s / c)
    mask = fops.band_mask(torch.from_numpy(pos), torch.from_numpy(kpos),
                          masks.get("sliding_window"),
                          masks.get("attention_chunk"))[:, None, None]
    s = torch.where(mask, s, torch.tensor(-torch.inf, dtype=s.dtype))
    ref = torch.logsumexp(s, dim=-1).reshape(2, 4, 30)
    live = torch.isfinite(ref)
    assert not live[:, :, :3].any() and live[:, :, 3:].all()
    np.testing.assert_allclose(lse[live].numpy(), ref[live].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.all(lse[~live] == fops.NEG_INF)


def test_prefill_attention_takes_the_function_only_under_grad():
    """Without grad (no operand requiring it, or ``torch.no_grad``) the
    wrapper returns the plain forward's output with no graph; with it, the
    same numbers through ``PrefillAttention``."""
    q, k, v, _, pos = _inputs(11, 1, 20, 4, 2, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    plain = fops.prefill_attention(tq, tk, tv, tpos, tpos, sliding_window=7)
    assert plain.grad_fn is None
    with torch.no_grad():
        quiet = fops.prefill_attention(tq.requires_grad_(), tk, tv, tpos,
                                       tpos, sliding_window=7)
    assert quiet.grad_fn is None
    graded = fops.prefill_attention(tq, tk, tv, tpos, tpos, sliding_window=7)
    assert graded.grad_fn is not None
    assert torch.equal(plain, quiet) and torch.equal(plain, graded.detach())


def test_bwd_wrapper_checks_its_operands():
    q, k, v, do, pos = _inputs(12, 1, 10, 4, 2, 16)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tpos = torch.from_numpy(pos)
    o, lse = fops.prefill_attention_plain(tq, tk, tv, tpos, tpos,
                                          return_lse=True)
    with pytest.raises(ValueError):
        fops.prefill_attention_bwd(tq, tk, tv, o, lse.transpose(1, 2), tdo,
                                   tpos, tpos)
    with pytest.raises(ValueError):
        fops.prefill_attention_bwd(tq, tk, tv, o[:, :5], lse, tdo, tpos,
                                   tpos)
    dq, dk, dv = fops.prefill_attention_bwd(tq, tk, tv, o, lse, tdo, tpos,
                                            tpos)
    assert dq.shape == tq.shape and dk.shape == tk.shape \
        and dv.shape == tv.shape
