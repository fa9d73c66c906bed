"""The gradient of the expert FFN (kernel K7's backward) held against the
JAX package on the CPU.

The JAX package has no backward kernel: its loss differentiates
``repro.models.moe.expert_ffn`` (three einsums) with XLA.  Here the same
numpy inputs go through ``jax.vjp`` of ``expert_ffn`` (and, in f32, of the
Pallas kernel's oracle ``moe_ffn_ref``) and through the port's plain
backward ``moe_ffn_bwd_plain`` (recomputing A, h and g, or reading those
that the plain forward returns, as the card's bf16 training kernels read
the training forward's), its autograd Function ``MoeFFN`` (which
``moe_ffn`` takes when an operand requires grad) and the whole MoE layer.
The CUDA kernels are held against the plain backward on the card by
tests/test_torch_kernels_gpu.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.moe_ffn.ref import moe_ffn_ref
from repro.models.layers import _activation as jax_activation
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels.moe_ffn import ops as mops
from repro_torch.models import moe as TMOE

#: f32 gradients: the largest difference over the output's largest entry
#: (sums in another order than XLA's)
F32_GRAD_REL = 2e-5
#: bf16 gradients: two bf16 steps of the output's largest entry.  XLA
#: rounds each op of the activation's derivative to bf16, the port rounds
#: dG once from f32, and each side rounds its products' sums in its own
#: order
BF16_GRAD_REL = 2.0 ** -6
ACTIVATIONS = ["silu", "gelu", "relu2"]
#: (E, C, d, f): a width the Pallas kernel's f_block divides, and an odd
#: d and f (phi-tiny-moe's f = 915 is odd too) that no tile divides
SHAPES = {"even": (4, 8, 64, 48), "odd": (3, 7, 37, 77)}


def _inputs(seed, e, c, d, f, tokenless=1, empty_tail=2):
    """Dispatch buffer, weights and cotangent as the MoE layer makes them:
    expert ``tokenless`` holds no token (all rows zero), every expert's
    last ``empty_tail`` slots are empty, and the cotangent is zero on
    every empty slot (the combine never reads one)."""
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=(e, c, d)).astype(np.float32)
    dout = rng.normal(size=(e, c, d)).astype(np.float32)
    xd[:, c - empty_tail:] = 0.0
    xd[tokenless] = 0.0
    dout[xd == 0.0] = 0.0
    ws = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return [xd, *ws, dout]


def _round(arrays, dtype):
    """The arrays rounded to ``dtype`` (bf16 by JAX), as float32 numpy, so
    that both packages read the same values."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return [np.array(jnp.asarray(a, jd), np.float32) for a in arrays]


def _cfg(activation):
    return dataclasses.replace(get_config("phi-tiny-moe").reduced(),
                               activation=activation)


def _jax_vjp(arrays, activation, dtype, oracle=False):
    """jax.vjp of ``expert_ffn`` (or of ``moe_ffn_ref``) at the cotangent,
    jitted, in ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cfg = _cfg(activation)

    def fn(xd, wi, wg, wo):
        if oracle:
            return moe_ffn_ref(xd, wi, wg, wo, activation=activation)
        return JMOE.expert_ffn(xd, {"wi": wi, "wg": wg, "wo": wo}, cfg)

    @jax.jit
    def grads(xd, wi, wg, wo, dout):
        return jax.vjp(fn, xd, wi, wg, wo)[1](dout)

    return [np.asarray(g, np.float32)
            for g in grads(*(jnp.asarray(a, jd) for a in arrays))]


def _torch(arrays, dtype):
    td = getattr(torch, dtype)
    return [torch.from_numpy(a).to(td) for a in arrays]


def _assert_rel(got, ref, rel, what=""):
    for name, g, r in zip(("dxd", "dwi", "dwg", "dwo"), got, ref):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == r.shape, (what, name)
        scale = np.abs(r).max()
        assert scale > 0, (what, name)
        err = np.abs(g - r).max()
        assert err <= rel * scale, (what, name, err, scale)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_backward_matches_jax_vjp(activation, dtype, shape):
    """``moe_ffn_bwd_plain`` against ``jax.vjp`` of JAX's ``expert_ffn``:
    f32 within ``F32_GRAD_REL`` and bf16 within ``BF16_GRAD_REL`` of each
    output's largest entry, with a tokenless expert and empty tail slots."""
    arrays = _round(_inputs(1, *SHAPES[shape]), dtype)
    ref = _jax_vjp(arrays, activation, dtype)
    got = mops.moe_ffn_bwd_plain(*_torch(arrays, dtype), activation)
    assert all(str(g.dtype)[6:] == dtype for g in got)
    _assert_rel(got, ref, F32_GRAD_REL if dtype == "float32"
                else BF16_GRAD_REL, (activation, dtype, shape))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_forward_residuals_match_jax(activation, dtype, shape):
    """``moe_ffn_plain(..., residuals=True)``: its output is
    ``moe_ffn_plain``'s bit for bit, and its output, A, h and g match
    JAX's ``expert_ffn`` and the einsums inside it (h = xd wi, g = xd wg,
    A = act(g) * h) within ``F32_GRAD_REL`` in f32 and ``BF16_GRAD_REL``
    in bf16 of each one's largest entry (each side sums in its own order,
    and a sum at a rounding boundary rounds one bf16 step apart)."""
    arrays = _round(_inputs(8, *SHAPES[shape]), dtype)[:4]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xd, wi, wg, wo = (jnp.asarray(a, jd) for a in arrays)
    jh = jnp.einsum("ecd,edf->ecf", xd, wi)
    jg = jnp.einsum("ecd,edf->ecf", xd, wg)
    ja = jax_activation(activation)(jg) * jh
    jout = JMOE.expert_ffn(xd, {"wi": wi, "wg": wg, "wo": wo},
                           _cfg(activation))
    args = _torch(arrays, dtype)
    out, (a, h, g) = mops.moe_ffn_plain(*args, activation, residuals=True)
    assert torch.equal(out, mops.moe_ffn_plain(*args, activation))
    rel = F32_GRAD_REL if dtype == "float32" else BF16_GRAD_REL
    for name, got, ref in (("out", out, jout), ("A", a, ja), ("h", h, jh),
                           ("g", g, jg)):
        assert str(got.dtype)[6:] == dtype, name
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= rel * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_saved_backward_equals_recompute(activation, dtype, shape):
    """The plain backward from the plain forward's (A, h, g) gives the
    same bits as its recompute of them from xd, with a tokenless expert and
    empty tail slots."""
    xd, wi, wg, wo, dout = _torch(_round(_inputs(9, *SHAPES[shape]), dtype),
                                  dtype)
    _, saved = mops.moe_ffn_plain(xd, wi, wg, wo, activation, residuals=True)
    got = mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation,
                                 saved=saved)
    ref = mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_saved_backward_matches_jax_vjp(activation, dtype):
    """The path bf16 takes on the card, on the CPU: the plain forward's
    residuals fed to the plain backward, against ``jax.vjp`` of JAX's
    ``expert_ffn`` at the odd f (tokenless expert, empty tail slots) within
    ``F32_GRAD_REL`` / ``BF16_GRAD_REL`` of each output's largest entry."""
    arrays = _round(_inputs(10, *SHAPES["odd"]), dtype)
    ref = _jax_vjp(arrays, activation, dtype)
    xd, wi, wg, wo, dout = _torch(arrays, dtype)
    _, saved = mops.moe_ffn_plain(xd, wi, wg, wo, activation, residuals=True)
    got = mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation,
                                 saved=saved)
    _assert_rel(got, ref, F32_GRAD_REL if dtype == "float32"
                else BF16_GRAD_REL, (activation, dtype))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_backward_matches_pallas_oracle_in_f32(activation):
    """f32: the gradient of the Pallas kernel's oracle (its einsums in f32)
    at the odd widths the Pallas kernel itself refuses."""
    arrays = _inputs(2, *SHAPES["odd"])
    ref = _jax_vjp(arrays, activation, "float32", oracle=True)
    got = mops.moe_ffn_bwd_plain(*_torch(arrays, "float32"), activation)
    _assert_rel(got, ref, F32_GRAD_REL, activation)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tokenless_expert_gets_exact_zero_grads(dtype):
    """An expert without a token (all its rows zero) gets exact zeros for
    dWi, dWg and dWo, and its rows and the empty tail slots exact zeros
    for dX."""
    xd, wi, wg, wo, dout = _torch(_inputs(3, *SHAPES["odd"]), dtype)
    dx, dwi, dwg, dwo = mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout)
    for g in (dwi[1], dwg[1], dwo[1], dx[1], dx[:, -2:]):
        assert torch.all(g == 0)
    assert all(g[0].abs().sum() > 0 for g in (dwi, dwg, dwo, dx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_function_matches_autograd_of_plain(activation, dtype):
    """``moe_ffn`` on CPU tensors that require grad goes through
    ``MoeFFN`` (its backward the plain backward, no kernel counted) and
    matches autograd of ``moe_ffn_plain``: f32 within 1e-6 of each
    output's largest entry; bf16 within ``BF16_GRAD_REL`` (autograd rounds
    each op of the activation's derivative, the plain backward dG once)."""
    arrays = _round(_inputs(4, *SHAPES["odd"]), dtype)
    xd, wi, wg, wo, dout = _torch(arrays, dtype)
    launches = mops.moe_ffn.launches, mops.moe_ffn_bwd.launches
    leaves = [t.clone().requires_grad_() for t in (xd, wi, wg, wo)]
    out = mops.moe_ffn(*leaves, activation=activation)
    assert type(out.grad_fn).__name__ == "MoeFFNBackward"
    got = torch.autograd.grad(out, leaves, dout)
    assert (mops.moe_ffn.launches, mops.moe_ffn_bwd.launches) == launches
    direct = mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout, activation)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))
    leaves = [t.clone().requires_grad_() for t in (xd, wi, wg, wo)]
    ref = torch.autograd.grad(mops.moe_ffn_plain(*leaves, activation),
                              leaves, dout)
    _assert_rel(got, [r.float().numpy() for r in ref],
                1e-6 if dtype == "float32" else BF16_GRAD_REL,
                (activation, dtype))


def test_moe_ffn_bwd_checks_its_operands():
    xd, wi, wg, wo, dout = _torch(_inputs(5, *SHAPES["even"]), "float32")
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout[:, :-1])
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout.bfloat16())
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout, activation="tanh")
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi[:, :-1], wg, wo, dout)
    with pytest.raises(ValueError):
        mops.moe_ffn_bwd(xd, wi, wg, wo, dout,
                         skipped=torch.zeros(1, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _layer(arch, dtype):
    """(cfg, tcfg, JAX layer-0 MoE params, the port's) of the reduced
    model, from PRNGKey(0), bridged; in f32 widened on both sides."""
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tl = {k: (v[0] if isinstance(v, torch.Tensor)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["layers"]["moe"].items()}
    if dtype == "float32":
        jl = jax.tree.map(lambda a: a.astype(jnp.float32), jl)
        tl = {k: (v.float() if isinstance(v, torch.Tensor)
                  else {kk: vv.float() for kk, vv in v.items()})
              for k, v in tl.items()}
    return cfg, tcfg, jl, tl


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,dtype", [
    ("phi-tiny-moe", "float32"), ("phi-tiny-moe", "bfloat16"),
    ("qwen2-moe", "float32")])
def test_moe_layer_grads_match_jax(arch, dtype):
    """The gradient of ``sum(y * ct) + aux`` through the whole layer
    (router, dispatch gather, the expert FFN's Function, combine, the
    shared expert) with respect to x and every parameter, against
    ``jax.grad`` of JAX's ``moe_layer``: f32 within ``F32_GRAD_REL`` and
    bf16 within ``BF16_GRAD_REL`` of each leaf's largest entry.  The rows
    lean towards expert 0's router column, so at a capacity factor of 1.25
    over 48 rows it overflows and assignments drop (asserted)."""
    cfg, tcfg, jl, tl = _layer(arch, dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(6)
    r0 = np.asarray(jl["router"][:, 0], np.float32)
    x = rng.normal(size=(2, 24, cfg.d_model)) + 4.0 * r0 / np.linalg.norm(r0)
    x = np.array(jnp.asarray(x, jd), np.float32)
    ct = np.array(jnp.asarray(rng.normal(size=x.shape), jd), np.float32)

    def jloss(x, p):
        y, aux = JMOE.moe_layer(x, p, cfg, capacity_factor=1.25)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(ct)) + aux

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x, jd), jl)
    ref = {"x": np.asarray(jgx, np.float32)}
    ref.update({k: np.asarray(v, np.float32)
                for k, v in _flat(jgp).items()})

    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).requires_grad_()
    leaves = _flat(tl)
    for t in leaves.values():
        t.requires_grad_(True)
    y, probs, ids = TMOE.moe_layer(tx, tl, tcfg, capacity_factor=1.25)
    loss = torch.sum(y.float() * torch.from_numpy(ct)) \
        + TMOE.load_balance_loss(probs, ids, tcfg.moe.num_experts)
    t, k, e = 48, tcfg.moe.top_k, tcfg.moe.num_experts
    slot_token, _ = TMOE.build_dispatch(ids, torch.ones(ids.shape), e,
                                        max(int(t * k / e * 1.25), 4))
    assert int((slot_token < t).sum()) < t * k      # some choices dropped
    names = ["x", *leaves]
    grads = torch.autograd.grad(loss, [tx, *leaves.values()])
    got = dict(zip(names, grads))
    assert got.keys() == ref.keys()
    rel = F32_GRAD_REL if dtype == "float32" else BF16_GRAD_REL
    for name, r in ref.items():
        g = got[name].float().numpy()
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= rel * scale, \
            (name, np.abs(g - r).max(), scale)


def test_dispatch_and_combine_gradients_equal_autograds(monkeypatch):
    """The dispatch gather and the combine take each other as their
    gradient (no scatter into the slots or tokens); in f32 the layer's
    gradients equal, bit for bit, those of autograd's own backward of the
    plain indexing, with dropped choices and empty slots (capacity factor
    1.25 over rows leaning to expert 0)."""
    cfg, tcfg, jl, tl = _layer("phi-tiny-moe", "float32")
    rng = np.random.default_rng(7)
    r0 = np.asarray(jl["router"][:, 0], np.float32)
    x = rng.normal(size=(2, 24, cfg.d_model)) + 4.0 * r0 / np.linalg.norm(r0)
    x = torch.from_numpy(x.astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))

    def grads():
        leaves = [x.clone().requires_grad_(),
                  *(t.clone().requires_grad_() for t in _flat(tl).values())]
        p = dict(zip(_flat(tl), leaves[1:]))
        y, _, _ = TMOE.moe_layer(leaves[0], p, tcfg, capacity_factor=1.25)
        return torch.autograd.grad(torch.sum(y * ct), leaves)

    ours = grads()
    monkeypatch.setattr(TMOE._DispatchGather, "apply",
                        lambda xt, st, pt: TMOE._gather_slots(xt, st))
    monkeypatch.setattr(TMOE._SumSlots, "apply",
                        lambda rows, pt: TMOE._sum_slots(rows, pt))
    autograds = grads()
    assert all(torch.equal(a, b) for a, b in zip(ours, autograds))
    assert all(g.abs().sum() > 0 for g in ours)
