"""The port's loss and gradients held against the JAX package on the CPU,
for every family the port serves (the rest of the training path is in
tests/test_torch_train.py, whose weights and batches these tests share).

``loss_fn`` against ``repro.models.model.loss_fn``, gradients leaf by
leaf against ``jax.grad`` of it, the blocks' recompute in the backward
pass, and the kernels' plain versions staying differentiable on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import model as TM
from test_torch_model import _leaves, _map
from test_torch_train import ARCHS, LLAMA4, _batch, _models

#: f32 losses: sums in another order than XLA's (measured: 1e-6 at 6.3)
LOSS_TOL = dict(rtol=1e-6, atol=5e-6)
#: f32 gradients, per leaf: the largest difference over the leaf's largest
#: entry (measured: at most 4.1e-6, zamba2-7b)
F32_GRAD_REL = 2e-5
#: bf16 gradients, per leaf: two bf16 steps of the leaf's largest entry.
#: Each framework rounds its products to bf16 in another order, the
#: embedding's duplicate token rows sum in another order, and the
#: attention backward rounds once where XLA rounds p and each product
#: (measured: up to 1.0e-2, yi-6b's wq)
BF16_GRAD_REL = 2.0 ** -6


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, dtype):
    cfg, _, jp, _ = _models(arch, dtype)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, cfg), has_aux=True))(jp, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(_leaves(jax.tree.map(
                lambda a: np.asarray(a, np.float32), grads))))


def _port_value_and_grad(arch, dtype):
    cfg, tcfg, _, tp = _models(arch, dtype)
    tp = _map(tp, lambda t: t.detach().clone())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    paths, leaves = zip(*_leaves(tp))
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = TM.loss_fn(tp, batch, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(paths, grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    """f32: loss, nll and the MoE load-balance term (aux, unweighted in the
    metrics, times ``lb_loss_weight`` in the loss) against JAX's
    ``loss_fn``; the vlm's prefix positions are cut off, masked labels
    count nothing."""
    jl, jm, _ = _jax_value_and_grad(arch, "float32")
    tl, tm, _ = _port_value_and_grad(arch, "float32")
    np.testing.assert_allclose(float(tl), jl, **LOSS_TOL)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), jm[k], **LOSS_TOL)
    if "moe" in arch or arch == LLAMA4:
        assert jm["aux"] > 0


def test_loss_fn_gathers_what_the_one_hot_contracts():
    """The target logit gathered equals JAX's one-hot contraction bit for
    bit on finite logits, and a batch whose labels are all masked has
    loss 0."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 6, 50)).astype(np.float32) * 30
    labels = rng.integers(-1, 50, size=(2, 6)).astype(np.int32)
    onehot = jax.nn.one_hot(jnp.maximum(labels, 0), 50, dtype=jnp.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(logits) * onehot, axis=-1))
    got = torch.gather(torch.from_numpy(logits), -1, torch.from_numpy(
        labels).clamp(min=0).long()[..., None])[..., 0].numpy()
    np.testing.assert_array_equal(got, ref)
    cfg, tcfg, _, tp = _models("yi-6b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    batch["labels"] = torch.full_like(batch["labels"], -1)
    loss, _ = TM.loss_fn(tp, batch, tcfg)
    assert float(loss) == 0.0


@pytest.mark.parametrize("arch,dtype", [
    ("yi-6b", "float32"), ("yi-6b", "bfloat16"), ("command-r-35b", "float32"),
    ("zamba2-7b", "float32"), ("qwen2-moe", "float32"),
    ("qwen2-vl-72b", "float32"), ("xlstm-1.3b", "float32")])
def test_grads_match_jax(arch, dtype):
    """Gradients leaf by leaf against ``jax.grad`` of JAX's ``loss_fn``:
    dense, parallel blocks with tied embeddings, hybrid (K4 in the shared
    block), MoE (the plain expert FFN stays differentiable on the CPU),
    vlm and ssm; f32 within ``F32_GRAD_REL`` of each leaf's largest entry,
    bf16 (in the parameters' dtype, as JAX's) within ``BF16_GRAD_REL``."""
    _, _, jg = _jax_value_and_grad(arch, dtype)
    _, _, tg = _port_value_and_grad(arch, dtype)
    assert jg.keys() == tg.keys()
    rel = F32_GRAD_REL if dtype == "float32" else BF16_GRAD_REL
    for path, r in jg.items():
        g = tg[path]
        assert str(g.dtype)[6:] == dtype, path
        assert g.shape == r.shape, path
        err = np.abs(g.float().numpy() - r).max()
        scale = np.abs(r).max()
        assert scale > 0, path
        assert err <= rel * scale, (path, err, scale)


def test_blocks_are_recomputed_in_the_backward(monkeypatch):
    """With grad on, each block runs under ``torch.utils.checkpoint``:
    attention's forward runs twice a layer (the pass, and the recompute
    whose saved output and LSE the backward reads) and its backward once;
    the gradients equal those of a pass without recompute bit for bit."""
    cfg, tcfg, _, tp = _models("yi-6b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = fops.prefill_attention_plain, \
        fops.prefill_attention_bwd_plain

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return plain_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return plain_bwd(*a, **kw)

    monkeypatch.setattr(fops, "prefill_attention_plain", fwd)
    monkeypatch.setattr(fops, "prefill_attention_bwd_plain", bwd)

    def grads():
        p = _map(tp, lambda t: t.detach().clone().requires_grad_())
        leaves = [t for _, t in _leaves(p)]
        loss, _ = TM.loss_fn(p, batch, tcfg)
        return torch.autograd.grad(loss, leaves)

    remat = grads()
    assert calls == {"fwd": 2 * tcfg.num_layers, "bwd": tcfg.num_layers}
    monkeypatch.setattr(TM, "_wants_grad", lambda params: False)
    calls.update(fwd=0, bwd=0)
    once = grads()
    assert calls == {"fwd": tcfg.num_layers, "bwd": tcfg.num_layers}
    for a, b in zip(remat, once):
        assert torch.equal(a, b)


def test_plain_versions_stay_differentiable_on_cpu():
    """The wrappers of kernels without a backward run their plain versions
    on the CPU, which autograd differentiates: the expert FFN's gradient
    reaches its weights (MoE trains on the CPU as JAX's does)."""
    from repro_torch.kernels.moe_ffn import ops as mops
    gen = torch.Generator().manual_seed(0)
    xd, wi, wg, wo = (torch.randn(s, generator=gen).requires_grad_()
                      for s in ((2, 3, 8), (2, 8, 5), (2, 8, 5), (2, 5, 8)))
    out = mops.moe_ffn(xd, wi, wg, wo)
    grads = torch.autograd.grad(out.sum(), (xd, wi, wg, wo))
    assert all(g.abs().sum() > 0 for g in grads)
