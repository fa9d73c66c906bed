"""The architectures of the port beyond the plain dense and all-MoE stacks,
held against the JAX package at the reduced size: Llama-4 (interleaved
dense/MoE pairs, ``layer_period`` 2 put back after ``reduced()`` with 4
layers; 4 experts top-1 plus a shared expert, qk-norm, an attention chunk
of 64), Command-R (parallel attention+MLP blocks, tied embeddings) and
DBRX (fine-grained MoE, every layer: 4 experts top-2 when reduced, 16
top-4 at full width).
JAX weights cross with the bridge; the schema, ``param_count``, forward,
prefill, four decode steps and the serving engine's seed-golden workload
agree with the JAX package on the same inputs, each at its stated
tolerance.  Plus the full-width parameter counts, the init draws of one
matrix at a time, and the CLI."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import H100_NVLINK, HarvestRuntime
from repro.models import model as JM
from repro.models import params as JP
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models.moe import moe_layer
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine
from test_torch_engine import _assert_same_run, _run
from test_torch_model import _leaves, _map, _pools, _to_numpy

# bf16 logits of a reduced model: the decode-equivalence tolerance of
# tests/test_decode_equivalence.py (as in tests/test_torch_model.py)
LOGIT_TOL = 0.02
# f32 weights: sums in another order, no bf16 rounding
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 stacked KV: Llama-4's k is qk-normed (RMS 1, entries up to about 4,
# where one bf16 step is 2^-6), and the 1-ulp differences of the residual
# stream (ROADMAP C) reach it through wk and the norm: LOGIT_TOL plus two
# bf16 steps of the entry's magnitude
KV_TOL = dict(rtol=2.0 ** -6, atol=LOGIT_TOL)
MiB = 2 ** 20

LLAMA4 = "llama4-maverick-400b-a17b"
COMMAND_R = "command-r-35b"
DBRX = "dbrx-132b"


def _reduced(get, arch):
    """``arch`` reduced; Llama-4 with 4 layers and its interleaving put
    back (``reduced()`` sets ``layer_period`` to 1)."""
    cfg = get(arch).reduced()
    if arch == LLAMA4:
        cfg = dataclasses.replace(
            cfg, num_layers=4,
            moe=dataclasses.replace(cfg.moe, layer_period=2))
    return cfg


@pytest.fixture(scope="module", params=[LLAMA4, COMMAND_R, DBRX])
def arch(request):
    cfg, tcfg = _reduced(get_config, request.param), \
        _reduced(t_get_config, request.param)
    assert cfg.parallel_block == (request.param == COMMAND_R)
    assert (cfg.moe is not None and cfg.moe.layer_period == 2) == \
        (request.param == LLAMA4)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _f32_params(jp, tp):
    """The same weights widened to f32 on both sides (bf16 -> f32 is
    exact)."""
    return (jax.tree.map(lambda a: a.astype(jnp.float32), jp),
            _map(tp, lambda t: t.float()))


def _close(got: torch.Tensor, want, dtype, kv=False, ties=(), gaps=None):
    """``got`` against ``want`` at ``dtype``'s tolerance.  bf16 logits:
    every row (index over all but the vocab dim) within LOGIT_TOL but the
    rows ``ties`` names, each of which must be out of it and a router near
    tie (``gaps`` at it below ROUTER_TIE)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    elif kv:
        np.testing.assert_allclose(got, want, **KV_TOL)
    else:
        row_err = np.abs(got - want).max(-1)
        assert [tuple(int(i) for i in r) for r in np.argwhere(
            row_err >= LOGIT_TOL)] == list(ties), row_err.max()
        assert all(gaps[r] < ROUTER_TIE for r in ties), \
            [float(gaps[r]) for r in ties]


#: the largest gap between a row's k-th and (k + 1)-th router logit that
#: counts as a near tie: the one-ulp bf16 differences of the normed input
#: (ROADMAP C) move a router logit by up to about 1e-4 at these widths
ROUTER_TIE = 1e-3

#: bf16 rows (batch row, position) whose logits leave LOGIT_TOL because a
#: router near tie sent them to another expert in one package than in the
#: other (forward), or in the port's decode step than in its forward
#: (serve_step: (step, batch row)); their gaps in the reduced DBRX's second
#: layer are 2.5e-5 to 2.5e-4.  Every other row is held to LOGIT_TOL, and
#: in f32 every row to F32_TOL.
KNOWN_ROUTER_TIES = {(DBRX, "forward"): [(1, 21), (1, 26), (1, 71)],
                     (DBRX, "serve_step"): [(1, 1)]}


def _router_gaps(monkeypatch, run):
    """Run ``run()`` with the port's MoE layers watched; returns the least
    gap over the layers between each row's k-th and (k + 1)-th router
    logit, (b, s), or None for a model without MoE layers."""
    gaps = []

    def watched(x, p, cfg, **kw):
        y, probs, ids = moe_layer(x, p, cfg, **kw)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.moe.top_k
        gaps.append(torch.log(top[:, k - 1] / top[:, k]).view(x.shape[:2]))
        return y, probs, ids

    monkeypatch.setattr(TM, "moe_layer", watched)
    out = run()
    monkeypatch.undo()
    return out, (torch.stack(gaps).amin(0).numpy() if gaps else None)


# ---------------------------------------------------------------------------
# schema, bridge, parameter counts, init
# ---------------------------------------------------------------------------


def test_schema_and_param_count_match_jax(arch):
    cfg, tcfg, jp, tp = arch
    jschema = dict(_leaves(JP.build_schema(cfg)))
    tschema = dict(_leaves(TP.build_schema(tcfg)))
    assert jschema.keys() == tschema.keys()
    for path, jd in jschema.items():
        td = tschema[path]
        assert (td.shape, td.init, td.dtype) == \
            (tuple(jd.shape), jd.init, jd.dtype), path
    if cfg.moe is not None and cfg.moe.layer_period == 2:
        assert set(tp) == {"embed", "lm_head", "final_norm", "blocks"}
        assert set(tp["blocks"]["dense"]) == {"ln1", "ln2", "attn", "mlp"}
        assert set(tp["blocks"]["moe"]) == {"ln1", "ln2", "attn", "moe"}
    elif cfg.moe is not None:     # every layer an MoE layer
        assert set(tp) == {"embed", "lm_head", "final_norm", "layers"}
        assert set(tp["layers"]) == {"ln1", "ln2", "attn", "moe"}
        assert tuple(tp["layers"]["moe"]["wi"].shape) == (
            cfg.num_layers, cfg.moe.num_experts, cfg.d_model,
            cfg.moe.d_ff_expert)
    else:     # parallel blocks keep one norm; the embedding is tied
        assert set(tp) == {"embed", "final_norm", "layers"}
        assert set(tp["layers"]) == {"ln1", "attn", "mlp"}
    assert TM.param_count(tp) == JM.param_count(jp)


def test_bridge_carries_the_blocks_tree(arch):
    """Every leaf, the interleaved ``blocks`` tree included, crosses bit
    for bit; a missing or misshapen leaf in it is refused."""
    cfg, tcfg, jp, tp = arch
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tflat = dict(_leaves(tp))
    assert jflat.keys() == tflat.keys()
    for path, a in jflat.items():
        back = _to_numpy(tflat[path])
        assert back.dtype == a.dtype and back.shape == a.shape, path
        assert np.array_equal(back.view(np.uint8), a.view(np.uint8)), path
    tree = jax.tree.map(np.asarray, jp)
    top = "blocks" if "blocks" in tree else "layers"
    inner = tree[top]["moe"] if top == "blocks" else tree[top]
    bad = dict(inner, attn=dict(inner["attn"], wq=inner["attn"]["wq"][:1]))
    bad = dict(tree[top], moe=bad) if top == "blocks" else bad
    with pytest.raises(ValueError):
        params_from_numpy(dict(tree, **{top: bad}), tcfg, "cpu")
    less = {k: v for k, v in inner.items() if k != "ln1"}
    less = dict(tree[top], moe=less) if top == "blocks" else less
    with pytest.raises(KeyError):
        params_from_numpy(dict(tree, **{top: less}), tcfg, "cpu")


@pytest.mark.parametrize("arch_id,layers,billions", [
    (LLAMA4, 4, 35.04), (COMMAND_R, 40, 30.28), ("nemotron-4-15b", 32, 15.63),
    ("qwen2-vl-72b", 36, 34.09), (DBRX, 10, 33.82)])
def test_full_width_param_counts_match_jax(arch_id, layers, billions):
    """The full-width schemas that chip_smoke.py serves (Llama-4 cut to
    two dense/MoE pairs, qwen2-vl-72b to 36 of 80 layers, dbrx-132b to 10
    of 40) count what the JAX package's count, leaf for leaf, without
    allocating them."""
    cfg = dataclasses.replace(get_config(arch_id), num_layers=layers)
    tcfg = dataclasses.replace(t_get_config(arch_id), num_layers=layers)
    jcount = JM.param_count(JP.abstract_params(cfg))
    tcount = sum(int(np.prod(d.shape))
                 for _, d in _leaves(TP.build_schema(tcfg)))
    assert tcount == jcount
    assert round(tcount / 1e9, 2) == billions


def test_init_draws_one_matrix_at_a_time(monkeypatch):
    """``init_params`` of a reduced interleaved config draws no more than
    a 2-D matrix at a time (one expert's (d, f), an attention projection's
    (d, heads * hd)), and every leaf has its schema's shape and dtype."""
    tcfg = _reduced(t_get_config, LLAMA4)
    draws = []
    randn = torch.randn

    def spy(*args, **kw):
        t = randn(*args, **kw)
        draws.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "randn", spy)
    params = TP.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert draws and max(len(s) for s in draws) <= 2, draws
    schema = dict(_leaves(TP.build_schema(tcfg)))
    # one draw per matrix past the stacked dims, in schema order: an
    # expert stack (L/2, E, d, f) is L/2 * E draws of (d, f)
    want = []
    for pd in schema.values():
        if pd.init == "normal":
            mat = pd.shape[pd.stacked:]
            want += [(mat[0], int(np.prod(mat[1:])))] \
                * int(np.prod(pd.shape[:pd.stacked]))
    assert draws == want
    mc = tcfg.moe
    moe = schema[("blocks", "moe", "moe", "wi")]
    assert moe.shape == (2, mc.num_experts, tcfg.d_model, mc.d_ff_expert) \
        and moe.stacked == 2
    got = dict(_leaves(params))
    assert got.keys() == schema.keys()
    for path, pd in schema.items():
        assert tuple(got[path].shape) == pd.shape, path
        assert got[path].dtype == TP.TORCH_DTYPES[pd.dtype], path


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _jit_forward(cfg):
    return jax.jit(lambda p, t, s: JM.forward(
        p, {"tokens": t, "positions": s}, cfg, want_kv=True))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_prefill_match_jax(arch, dtype, monkeypatch):
    """80 tokens: past Llama-4's reduced attention chunk of 64.  Logits
    and the stacked KV (layers in the JAX order, 0, 1, 2, ...) of
    ``forward``, and ``prefill``'s last-token logits; in bf16 every row
    but DBRX's named router near ties."""
    cfg, tcfg, jp, tp = arch
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 80)).astype(np.int32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80)).copy()
    jl, jo = _jit_forward(cfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
    batch = {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos)}
    (tl, to), gaps = _router_gaps(monkeypatch, lambda: TM.forward(
        tp, batch, tcfg, want_kv=True))
    assert str(tl.dtype) == f"torch.{dtype}"
    ties = KNOWN_ROUTER_TIES.get((cfg.name.removesuffix("-smoke"),
                                  "forward"), ()) \
        if dtype == "bfloat16" else ()
    _close(tl, jl, dtype, ties=ties, gaps=gaps)
    for jt, tt in zip(jo.kv, to.kv):
        assert tt.shape[0] == cfg.num_layers
        _close(tt, jt, dtype, kv=True)
    if cfg.moe is not None and not ties:
        # a tie's other expert moves the load-balance loss: where one is
        # named, the loss is held in f32 alone
        np.testing.assert_allclose(to.aux.item(), float(jo.aux), rtol=1e-5)
    jlast, _ = jax.jit(lambda p, t, s: JM.prefill(
        p, {"tokens": t, "positions": s}, cfg))(jp, jnp.asarray(toks),
                                                jnp.asarray(pos))
    tlast, tout = TM.prefill(tp, batch, tcfg)
    _close(tlast, jlast, dtype)
    assert tout.kv[0].shape == to.kv[0].shape


def test_serve_step_matches_jax_and_forward(arch, monkeypatch):
    """Four decode steps from pools filled by a 61-token prefill (the steps
    cross Llama-4's reduced attention chunk at 64): the port's logits
    against the jitted JAX serve_step and against its own forward (every
    row but a named router near tie); each step's k and v land in the
    pools in place, layer for layer in the JAX order."""
    cfg, tcfg, jp, tp = arch
    b, s, bs, n_extra = 2, 61, 8, 4
    npb = (s + n_extra + bs - 1) // bs
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + n_extra)).astype(
        np.int32)
    pos = np.broadcast_to(np.arange(s + n_extra, dtype=np.int32),
                          (b, s + n_extra)).copy()
    _, out = _jit_forward(cfg)(jp, jnp.asarray(toks[:, :s]),
                               jnp.asarray(pos[:, :s]))
    pk, pv, sr, sb = _pools(out.kv, s, bs, npb)
    (t_full, _), gaps = _router_gaps(monkeypatch, lambda: TM.forward(
        tp, {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos)}, tcfg))
    jstep = jax.jit(lambda p, st: JM.serve_step(p, st, cfg))
    jkv = JM.KVPools(*(jnp.asarray(a) for a in (pk, pv, sr, sb)),
                     jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32))
    tkv = TM.KVPools(*(torch.from_numpy(a.copy()) for a in (pk, pv, sr, sb)),
                     torch.zeros((b,), dtype=torch.int32),
                     torch.zeros((b,), dtype=torch.int32))
    jst = JM.DecodeState(tokens=None, pos=None, kv=jkv, peer=None,
                         states=None)
    tst = TM.DecodeState(tokens=None, pos=None, kv=tkv, peer=None)
    steps = []
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
        _close(tl, jl, "bfloat16")
        steps.append(tl)
    # (step, batch row) against the forward's rows at those positions
    _close(torch.stack(steps), t_full[:, s:].transpose(0, 1).float(),
           "bfloat16", ties=KNOWN_ROUTER_TIES.get(
               (cfg.name.removesuffix("-smoke"), "serve_step"), ()),
           gaps=None if gaps is None else gaps[:, s:].T)
    np.testing.assert_allclose(tkv.pool_k.numpy(), np.asarray(jst.kv.pool_k),
                               **KV_TOL)
    np.testing.assert_allclose(tkv.pool_v.numpy(), np.asarray(jst.kv.pool_v),
                               **KV_TOL)


# ---------------------------------------------------------------------------
# the serving engine and the CLI
# ---------------------------------------------------------------------------


#: bf16 engine steps (indices into the sampled logits) whose JAX
#: top-1/top-2 gap is within twice the step's largest logit difference
#: while the two deciding logits differ by a bf16 step (ROADMAP C's known
#: limit): at Llama-4's steps 4 and 41 the gap is one step (2^-7), at
#: step 39 JAX's two deciding logits tie exactly and the port's differ
#: by one step; at DBRX's step 30 the gap is 2^-8 and the port's
#: runner-up one step lower.  The tokens agree there all the same, and
#: in f32 every step is decided.
KNOWN_NEAR_TIES = {(LLAMA4, "bfloat16"): [4, 39, 41],
                   (DBRX, "bfloat16"): [30]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_matches_jax(arch, dtype):
    """The seed-golden ``_run`` workload through both engines: identical
    tokens, kv and allocator stats and clock, under the near-tie guard,
    with evictions to the peer and reloads; in bf16 and on the same
    weights widened to f32."""
    cfg, tcfg, jp, tp = arch
    if dtype == "float32":
        jp, tp = _f32_params(jp, tp)
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["reload_peer"] > 0, kv
    _assert_same_run(j, t, KNOWN_NEAR_TIES.get(
        (cfg.name.removesuffix("-smoke"), dtype), ()))


@pytest.mark.parametrize("arch_id", [LLAMA4, COMMAND_R, "nemotron-4-15b",
                                     "qwen2-vl-72b", DBRX, "zamba2-7b",
                                     "xlstm-1.3b"])
def test_cli_serves_the_arch_on_the_cpu(capsys, monkeypatch, arch_id):
    """``--arch`` serves ``cfg.reduced()`` as the JAX CLI does (Llama-4's
    reduced config has ``layer_period`` 1; qwen2-vl-72b's prefills run
    behind its 8 prefix embeddings; zamba2-7b and xlstm-1.3b carry
    recurrent states)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch_id, "--device", "cpu", "--scheduler",
        "fair", "--num-requests", "3", "--max-new-tokens", "4",
        "--fidelity-policy", "slo", "--mode", "async"])
    serve.main()
    assert "3/3 requests served" in capsys.readouterr().out


#: the two MoE configs of the catalog no other port test serves: Mixtral
#: (8 experts top-2, a sliding window, 64 when reduced) and Phi-3.5-MoE (16
#: experts top-2), reduced (4 experts top-2, every layer an MoE layer)
MORE_MOE = ["mixtral-8x7b", "phi-3.5-moe"]


@pytest.mark.parametrize("arch_id", MORE_MOE)
def test_more_moe_engines_match_jax(arch_id):
    """Reduced Mixtral and Phi-3.5-MoE, bf16, through both engines on the
    seed-golden ``_run`` workload: identical tokens, kv and allocator
    stats and clock, the sampled logits under the near-tie guard, with
    evictions to the peer and reloads."""
    cfg, tcfg = get_config(arch_id).reduced(), t_get_config(arch_id).reduced()
    assert cfg.family == "moe" and cfg.moe.layer_period == 1
    assert (cfg.moe.num_experts, cfg.moe.top_k) == (4, 2)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["reload_peer"] > 0, kv
    _assert_same_run(j, t, KNOWN_NEAR_TIES.get((arch_id, "bfloat16"), ()))
