"""The port's training path held against the JAX package on the CPU.

The copied data pipeline, ``abstract_params``, the bridge's way back,
three AdamW steps against JAX's ``train_step``, checkpoints crossing
between the packages bit for bit, and the port's training loop and CLI
(``loss_fn`` and the gradients of every family are in
tests/test_torch_train_grads.py).  Weights come from the JAX package and
cross with the bridge; f32 runs widen the same bf16 weights on both sides
(exact).  On the CPU attention's gradient runs through
``PrefillAttention`` with the plain versions (tests/test_torch_flash_grad.py
holds it alone).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train import optim as JO
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.data import pipeline as TD
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.train import checkpoint as TC
from repro_torch.train import optim as TO
from repro_torch.train.loop import cosine_lr, train
from test_torch_model import _leaves, _map, _to_numpy

LLAMA4 = "llama4-maverick-400b-a17b"
#: every family the port serves, at reduced size: dense with serial and
#: with parallel blocks (and tied embeddings), vlm behind its prefix, MoE
#: with layer_period 1 and 2 (Llama-4 at 4 layers, its interleaving put
#: back), hybrid (two super-blocks and a tail) and ssm (one super-block)
ARCHS = ["yi-6b", "command-r-35b", "qwen2-vl-72b", "qwen2-moe", LLAMA4,
         "zamba2-7b", "xlstm-1.3b"]
TINY = TModelConfig(name="tiny-dense", family="dense", source="test",
                    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    d_ff=128, vocab_size=256)


def _configs(arch):
    changes = {}
    if arch == LLAMA4:
        moe = get_config(arch).reduced().moe
        changes = dict(num_layers=4,
                       moe=dataclasses.replace(moe, layer_period=2))
    elif arch == "zamba2-7b":
        changes = dict(num_layers=5)
    elif arch == "xlstm-1.3b":
        changes = dict(num_layers=4)
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(t_get_config(arch).reduced(), **changes))


def _batch(cfg, b=2, s=40, seed=0):
    """Random tokens and labels (some masked with -1), positions, and the
    vlm's prefix embeddings (rounded to bf16, so that both sides read the
    same values)."""
    rng = np.random.default_rng(seed)
    npre = cfg.modality.num_prefix_embeddings if cfg.modality else 0
    out = dict(
        tokens=rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
        labels=rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
        positions=np.broadcast_to(np.arange(npre + s, dtype=np.int32),
                                  (b, npre + s)).copy())
    out["labels"][0, :5] = -1
    if npre:
        pre = rng.normal(size=(b, npre, cfg.d_model)).astype(np.float32)
        out["prefix_embeddings"] = np.asarray(
            jnp.asarray(pre, jnp.bfloat16), np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _models(arch, dtype):
    """(cfg, tcfg, JAX params, port params): the JAX package's weights
    from PRNGKey(0), bridged; in f32 widened on both sides."""
    cfg, tcfg = _configs(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = _map(tp, lambda t: t.float())
    return cfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# data, schema
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_matches_jax(seed):
    """The copied pipeline yields the JAX package's batches, shared
    prefixes included, and its tokenizer's ids."""
    text = "Harvest — peer GPU caching"
    assert TD.ByteTokenizer().encode(text) == JD.ByteTokenizer().encode(text)
    assert TD.ByteTokenizer().vocab_size == JD.ByteTokenizer().vocab_size
    ids = JD.ByteTokenizer().encode(text)
    assert TD.ByteTokenizer().decode(ids) == JD.ByteTokenizer().decode(ids)
    jb = JD.make_batches(JD.SyntheticCorpus(vocab_size=500, seed=seed), 3,
                         70, num_batches=4)
    tb = TD.make_batches(TD.SyntheticCorpus(vocab_size=500, seed=seed), 3,
                         70, num_batches=4)
    pairs = list(zip(jb, tb, strict=True))
    assert len(pairs) == 4
    for j, t in pairs:
        assert j.keys() == t.keys()
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax(arch):
    """``abstract_params`` holds the JAX package's ``ShapeDtypeStruct``
    tree's shapes and dtypes, on the meta device (no storage)."""
    cfg, tcfg = _configs(arch)
    jt = dict(_leaves(JM.abstract_params(cfg)))
    tt = dict(_leaves(TP.abstract_params(tcfg)))
    assert jt.keys() == tt.keys()
    for path, s in jt.items():
        t = tt[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype)[6:] == str(s.dtype), path
    assert TM.param_count(TP.abstract_params(tcfg)) \
        == JM.param_count(JM.abstract_params(cfg))


def test_abstract_params_at_full_width():
    """Full-width h2o-danube-3-4b on the meta device: 3.962 B parameters,
    all bf16, 7.92 GB, with nothing allocated."""
    cfg, tcfg = get_config("h2o-danube-3-4b"), t_get_config("h2o-danube-3-4b")
    ap = TP.abstract_params(tcfg)
    n = TM.param_count(ap)
    assert n == JM.param_count(JM.abstract_params(cfg))
    assert 3.96e9 < n < 3.97e9
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(ap))


def test_bridge_round_trips_through_numpy():
    """``params_to_numpy`` is ``params_from_numpy``'s reverse: bf16 leaves
    leave as their uint16 bits, equal to the JAX package's arrays', and come
    back bit for bit."""
    cfg, tcfg, jp, tp = _models("yi-6b", "bfloat16")
    back = params_to_numpy(tp)
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    for path, arr in _leaves(back):
        assert arr.dtype == np.uint16, path
        np.testing.assert_array_equal(arr, jl[path].view(np.uint16))
    again = params_from_numpy(back, tcfg, "cpu")
    for (path, a), (_, b) in zip(_leaves(tp), _leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the optimizer step
# ---------------------------------------------------------------------------


def test_train_step_matches_jax_for_three_steps():
    """Three fused steps (loss, grad, AdamW with clipping) from the same
    f32 weights on three batches, lr 1e-3, against JAX's ``train_step``:
    loss, nll, grad_norm tightly, mu and nu within 1e-4 of each leaf's
    largest entry, the step count exactly.  A parameter moves by ``lr * m
    / (sqrt(v) + eps)``, about +-lr whatever |g| while |g| >> eps: where a
    gradient entry sits near eps (1e-8) or within the two frameworks' f32
    noise of 0, its update is decided by that noise (up to 2 lr apart
    after a step), and the later steps' gradients follow the moved
    parameters.  So all but 1e-4 of the parameters are held to 2e-6, and
    every one within 2 lr a step (measured: 123 of 1.38 M entries past
    1e-6, at most 4.5e-5 at lr 1e-3)."""
    _hold_three_steps("yi-6b")


def test_moe_train_step_matches_jax_for_three_steps():
    """The same three steps for reduced phi-tiny-moe (4 experts top-2 of
    width 256, the gradient through the expert FFN's ``MoeFFN`` and its
    plain backward), the load-balance term in the loss, held as yi-6b's
    but for the moments after the third step: within 2e-4 of each leaf's
    largest entry.  After the first step they agree within 1e-5 (the
    same parameters on both sides); the noise-decided updates of that
    step (see above) then move the later gradients, most of all
    ``final_norm``'s, whose entries are small (measured: 1.6e-4 after the
    second step, 1.06e-4 after the third; yi-6b 5.3e-5)."""
    _hold_three_steps("phi-tiny-moe", mom_rel=2e-4)


def _hold_three_steps(arch, mom_rel=1e-4):
    cfg, tcfg, jp, tp = _models(arch, "float32")
    tp = _map(tp, lambda t: t.clone())
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    step = jax.jit(lambda p, o, b, lr: JO.train_step(p, o, b, cfg, lr=lr))
    lr, n = 1e-3, 3
    for i in range(n):
        nb = _batch(cfg, seed=10 + i)
        jp, jo, jm = step(jp, jo, {k: jnp.asarray(v) for k, v in nb.items()},
                          lr)
        tp, to, tm = TO.train_step(
            tp, to, {k: torch.from_numpy(v) for k, v in nb.items()}, tcfg,
            lr=lr)
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=2e-6, atol=5e-6, err_msg=k)
        if i == 0:       # the same parameters on both sides
            for jt, tt in ((jo.mu, to.mu), (jo.nu, to.nu)):
                jl = dict(_leaves(jax.tree.map(np.asarray, jt)))
                for path, t in _leaves(tt):
                    assert np.abs(t.numpy() - jl[path]).max() \
                        <= 1e-5 * np.abs(jl[path]).max(), path
    assert int(to.step) == int(jo.step) == n and to.step.dtype == torch.int32
    for name, jt, tt in (("mu", jo.mu, to.mu), ("nu", jo.nu, to.nu)):
        jl = dict(_leaves(jax.tree.map(np.asarray, jt)))
        for path, t in _leaves(tt):
            r = jl[path]
            assert t.dtype == torch.float32, path
            assert np.abs(t.numpy() - r).max() <= mom_rel \
                * np.abs(r).max(), (name, path)
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    off, total = 0, 0
    for path, t in _leaves(tp):
        d = np.abs(t.numpy() - jl[path])
        assert d.max() <= 2 * lr * n, path
        off += int((d > 2e-6).sum())
        total += d.size
    assert off <= 1e-4 * total, (off, total)


def test_adamw_update_in_pieces_equals_whole_leaves(monkeypatch):
    """The update walks each leaf in pieces; the arithmetic is
    elementwise, so pieces of 1,000 elements give the numbers of whole
    leaves but for the global norm, which sums the pieces in another order
    (to f32 rounding, and the clip scale with it)."""
    _, _, _, tp = _models("yi-6b", "float32")
    gen = torch.Generator().manual_seed(1)
    grads = _map(tp, lambda t: torch.randn(t.shape, generator=gen))
    runs = []
    for piece in (TO.PIECE, 1000):
        monkeypatch.setattr(TO, "PIECE", piece)
        p = _map(tp, lambda t: t.clone())
        opt = TO.adamw_init(p)
        for _ in range(2):
            p, opt, gnorm = TO.adamw_update(p, grads, opt, lr=1e-2)
        runs.append((p, opt, gnorm))
    (p0, o0, g0), (p1, o1, g1) = runs
    np.testing.assert_allclose(float(g1), float(g0), rtol=1e-6)
    for a, b in zip(TO.tree_leaves((p0, o0.mu, o0.nu)[0]),
                    TO.tree_leaves(p1)):
        # the norms differ in their last bits, so the clip scale may too
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _jax_trained(cfg, jp):
    """One JAX step from bf16 weights: bf16 params, nonzero f32 moments."""
    nb = {k: jnp.asarray(v) for k, v in _batch(cfg, seed=7).items()}
    return jax.jit(lambda p, o, b: JO.train_step(p, o, b, cfg))(
        jp, JO.adamw_init(jp), nb)[:2]


def _port_trained(cfg, tcfg, tp):
    """One step of the port from bf16 weights."""
    nb = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=7).items()}
    tp = _map(tp, lambda t: t.clone())
    return TO.train_step(tp, TO.adamw_init(tp), nb, tcfg)[:2]


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the JAX package wrote (bf16 params as uint16 bits, f32
    moments, the step) restores into the port's templates bit for bit."""
    cfg, tcfg, jp, tp = _models("yi-6b", "bfloat16")
    jp, jo = _jax_trained(cfg, jp)
    path = tmp_path / "jax.npz"
    JC.save_checkpoint(path, jp, jo, 1)
    tmpl = TP.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    params, opt, step = TC.restore_checkpoint(path, tmpl,
                                              TO.adamw_init(tmpl))
    assert step == 1 and int(opt.step) == 1 and opt.step.dtype == torch.int32
    for jt, tt in ((jp, params), (jo.mu, opt.mu), (jo.nu, opt.nu)):
        jl = dict(_leaves(jax.tree.map(np.asarray, jt)))
        for path_, t in _leaves(tt):
            a = _to_numpy(t)
            assert a.dtype == jl[path_].dtype, path_
            np.testing.assert_array_equal(a.view(np.uint8),
                                          jl[path_].view(np.uint8))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A checkpoint the port wrote restores into the JAX package's
    templates bit for bit, with the same keys."""
    cfg, tcfg, jp, tp = _models("yi-6b", "bfloat16")
    tp, to = _port_trained(cfg, tcfg, tp)
    path = tmp_path / "port.npz"
    TC.save_checkpoint(path, tp, to, 1)
    jpath = tmp_path / "jax.npz"
    JC.save_checkpoint(jpath, jp, JO.adamw_init(jp), 1)
    assert set(np.load(path).files) == set(np.load(jpath).files)
    params, opt, step = JC.restore_checkpoint(path, jp, JO.adamw_init(jp))
    assert step == 1 and int(opt.step) == 1
    for jt, tt in ((params, tp), (opt.mu, to.mu), (opt.nu, to.nu)):
        jl = dict(_leaves(jax.tree.map(np.asarray, jt)))
        for path_, t in _leaves(tt):
            a = _to_numpy(t)
            assert a.dtype == jl[path_].dtype, path_
            np.testing.assert_array_equal(a.view(np.uint8),
                                          jl[path_].view(np.uint8))


# ---------------------------------------------------------------------------
# the loop and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 5, 29])
def test_cosine_lr_matches_jax(step):
    from repro.train.loop import cosine_lr as jax_cosine_lr
    kw = dict(base=1e-3, warmup=4, total=30)
    assert cosine_lr(step, **kw) == jax_cosine_lr(step, **kw)


def test_train_loss_decreases(tmp_path):
    """The port's loop lowers the loss of a tiny dense model, as
    tests/test_system.py holds JAX's, and writes loadable checkpoints."""
    params, _opt, history = train(TINY, steps=30, batch=8, seq_len=32,
                                  lr=1e-3, log_every=5, seed=0,
                                  ckpt_dir=str(tmp_path), ckpt_every=25,
                                  device="cpu")
    losses = [h["loss"] for h in history]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, f"no learning: {losses}"
    assert all(h["tok_s"] > 0 for h in history)
    assert {p.name for p in tmp_path.glob("*.npz")} == {"step_000025.npz",
                                                         "final.npz"}


def test_train_resume_matches(tmp_path):
    """Training 10 steps == training 5, checkpointing, resuming 5."""
    kw = dict(steps=10, batch=4, seq_len=16, lr=5e-4, log_every=1, seed=3,
              device="cpu")
    _, _, h_full = train(TINY, **kw)
    train(TINY, ckpt_dir=str(tmp_path), ckpt_every=5, **kw)
    _, _, h_res = train(TINY, resume=str(tmp_path / "step_000005.npz"), **kw)
    assert [h["step"] for h in h_res] == list(range(5, 10))
    assert abs(h_full[-1]["loss"] - h_res[-1]["loss"]) < 1e-4


def test_train_cli_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch yi-6b --reduced
    --device cpu`` trains (a few short steps here) and logs as the JAX
    launcher does; without ``--device`` it asks for a card."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent
                                          / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq-len", "16", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "loss" in lines[0] and "tok/s" in lines[0]
    assert (tmp_path / "final.npz").exists()
    if not torch.cuda.is_available():
        from repro_torch.launch import train as launch
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])


def test_train_cli_trains_phi_tiny_moe_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch phi-tiny-moe --reduced
    --device cpu``: the MoE model trains through the expert FFN's
    Function, its losses finite."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent
                                          / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "phi-tiny-moe", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq-len", "16", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "loss" in lines[0], out.stdout
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    assert np.isfinite(losses).all(), lines
    assert (tmp_path / "final.npz").exists()
