"""The slice as a whole: the port's serving engine against the JAX engine,
run live side by side on the seed-golden workload of
tests/test_runtime_equivalence.py (yi-6b reduced to 2 layers, 4 requests x
12 tokens, fair scheduler, 10 local slots).  Tokens, kv and allocator stats
must be identical and the simulated clock equal; the logits each engine
samples from are recorded so the test can show that token equality is not
a coin toss.  Plus the front door, the CLI, the device default and import
hygiene."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import H100_NVLINK, HarvestRuntime
from repro.models import model as JM
from repro.serving import TenantSpec, Workload
from repro.serving.engine import HarvestServingEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch import serving as tserving
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.serving.engine import HarvestServingEngine as TorchEngine

MiB = 2**20
# largest |port - JAX| of a sampled bf16 logit vector allowed (the decode
# equivalence tolerance of tests/test_decode_equivalence.py)
LOGIT_TOL = 0.02


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_config("yi-6b").reduced(), num_layers=2)
    tcfg = dataclasses.replace(t_get_config("yi-6b").reduced(), num_layers=2)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _record_sampled_logits(eng):
    """Wrap the engine's host-side sampler to keep every logit vector it
    samples from; returns the list it fills."""
    sampled = []
    sample = eng._sample
    eng._sample = lambda logits: (sampled.append(
        np.asarray(logits, np.float32)), sample(logits))[1]
    return sampled


def _check_sampled_logits(jlog, tlog, known_near_ties=()):
    """Token equality is not a coin toss.  At this size the two packages'
    bf16 logits differ by a rounding step or two (XLA fuses and rounds
    some bf16 intermediates differently from eager PyTorch).  Every
    sampled vector must agree within LOGIT_TOL.  Each step's JAX
    top-1/top-2 gap must then stay above twice that step's largest
    difference d, so no perturbation within d can reorder the two; the
    only exception is a near tie (bf16 logits of the reduced model tie
    exactly at some steps), where the two deciding logits must be
    bit-identical, so first-index argmax picks the same token for the
    same reason.  ``known_near_ties``: the steps (indices into the logs)
    where a near tie's deciding logits are known to differ by a rounding
    step (ROADMAP C's known limit); there the tokens are held equal by
    the caller alone, and no other step may be such a step."""
    assert len(tlog) == len(jlog)
    decided, differing_ties = 0, []
    for i, (a, b) in enumerate(zip(jlog, tlog)):
        d = np.abs(a - b).max()
        assert d <= LOGIT_TOL
        top1, top2 = np.argsort(-a, kind="stable")[:2]
        if a[top1] - a[top2] > 2 * d:
            decided += 1
        elif not (a[top1] == b[top1] and a[top2] == b[top2]):
            differing_ties.append(i)
    assert differing_ties == list(known_near_ties)
    assert decided >= len(jlog) // 2


def _run(engine_cls, runtime_cls, hw, cfg, params, peer_budget, **kw):
    runtime = runtime_cls({1: peer_budget}, hardware=hw)
    eng = engine_cls(cfg, params, max_batch=2, block_size=8,
                     num_local_slots=10, max_seq_len=96, runtime=runtime,
                     scheduler="fair", **kw)
    sampled = _record_sampled_logits(eng)
    reqs = [eng.submit([2 + i, 5, 7, 11, 13 + i], max_new_tokens=12)
            for i in range(4)]
    stats = eng.run(max_steps=800)
    return eng, reqs, stats, sampled


def _assert_same_run(j, t, known_near_ties=()):
    (je, jreqs, js, jlog), (te, treqs, ts, tlog) = j, t
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert dict(te.kv_mgr.stats) == dict(je.kv_mgr.stats)
    assert dict(te.allocator.stats) == dict(je.allocator.stats)
    assert ts.clock_s == pytest.approx(js.clock_s, rel=1e-9)
    assert (ts.steps, ts.tokens_out, ts.preemptions) == \
        (js.steps, js.tokens_out, js.preemptions)
    ts.check_clock_identity()
    js.check_clock_identity()
    assert len(jlog) == js.tokens_out
    _check_sampled_logits(jlog, tlog, known_near_ties)


def test_sync_engine_matches_jax(models):
    cfg, tcfg, jp, tp = models
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    assert j[0].kv_mgr.stats["evict_to_peer"] > 0
    _assert_same_run(j, t)


def test_async_slo_fidelity_engine_matches_jax(models):
    """Async clock with the per-SLO fidelity policy and a peer budget that
    holds two quantized blocks: int8 demotions go to peer and host through
    K2/K3 (their plain versions here) and back."""
    cfg, tcfg, jp, tp = models
    budget = 4200
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, budget,
             mode="async", fidelity_policy="slo")
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             budget, mode="async", fidelity_policy="slo", device="cpu")
    kv = j[0].kv_mgr.stats
    assert kv["evict_to_peer"] > 0 and kv["evict_to_host"] > 0
    jfid = j[0].runtime.stats()["fid"]
    assert jfid["demote_int8"] > 0
    assert t[0].runtime.stats()["fid"] == jfid
    _assert_same_run(j, t)


def test_gq6_engine_matches_jax():
    """nemotron-4-15b reduced with its GQA group of 6 kept (12 q over 2 kv
    heads; ``reduced()`` alone gives 4 over 1), as dbrx-132b and
    nemotron-4-15b fold 48 q heads over 8 kv heads: the seed-golden
    workload of ``_run`` through both engines, identical tokens, stats
    and clock.  Known limit (ROADMAP C): at sampled step 33 the JAX
    top-1/top-2 gap is 2^-7 while the two deciding logits differ by
    2^-8 (one bf16 step, XLA's fusion against eager PyTorch), so the
    near-tie guard cannot call that step decided; the tokens agree there
    all the same, and every other step is decided or a bit-identical
    tie."""
    changes = dict(num_heads=12, num_kv_heads=2)
    cfg = dataclasses.replace(get_config("nemotron-4-15b").reduced(),
                              **changes)
    tcfg = dataclasses.replace(t_get_config("nemotron-4-15b").reduced(),
                               **changes)
    assert cfg.num_heads // cfg.num_kv_heads == 6
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    j = _run(JaxEngine, HarvestRuntime, H100_NVLINK, cfg, jp, 64 * MiB)
    t = _run(TorchEngine, tcore.HarvestRuntime, tcore.H100_NVLINK, tcfg, tp,
             64 * MiB, device="cpu")
    assert j[0].kv_mgr.stats["evict_to_peer"] > 0
    _assert_same_run(j, t, known_near_ties=[33])


SHARED_PREFIX = [9, 4, 7, 11, 13, 2, 5, 8, 21, 30, 31, 32, 40, 41, 42, 43]


def _run_variant(engine_cls, core, params, cfg, variant, **kw):
    """``test_engine_variants_match_jax``'s workload for ``variant``
    through one engine (``core``: its package's ``core``)."""
    if variant == "disaggregated":
        topo = core.get_topology("h100-dcn-2host")
        runtime = core.HarvestRuntime(topo.device_budgets(64 * MiB),
                                      topology=topo)
        kw["disaggregated"] = True
    else:
        runtime = core.HarvestRuntime({1: 64 * MiB})
    if variant == "chunked_prefill":
        kw["chunk_prefill_tokens"] = 8
    if variant == "prefix_cache":
        kw["prefix_cache"] = True
    eng = engine_cls(cfg, params, max_batch=2, block_size=8,
                     num_local_slots=10, max_seq_len=96,
                     runtime=runtime, scheduler="fair", mode="async", **kw)
    sampled = _record_sampled_logits(eng)
    if variant == "prefix_cache":
        # the first request publishes the prefix on retiring; the next
        # three arrive together after it and share it
        reqs = [eng.submit_request(prompt=SHARED_PREFIX + [50],
                                   max_new_tokens=6)]
        reqs += [eng.submit_request(prompt=SHARED_PREFIX + [60 + i],
                                    max_new_tokens=6, arrival_t=2e-4)
                 for i in range(3)]
    else:
        reqs = [eng.submit([2 + i, 5, 7, 11, 13 + i] * 3,
                           max_new_tokens=8) for i in range(4)]
    return eng, reqs, eng.run(max_steps=800), sampled


@pytest.mark.parametrize("variant", ["chunked_prefill", "prefix_cache",
                                     "disaggregated"])
def test_engine_variants_match_jax(models, variant):
    """The remaining tensor sites of the engine: chunked prefill's final
    write (``_finish_prefill``), the prefix cache's copy-on-write twin
    (two requests adopting one published prefix at once), and the
    disaggregated prefill's streamed adopt over a two-host topology."""
    cfg, tcfg, jp, tp = models
    import repro.core as jcore
    j = _run_variant(JaxEngine, jcore, jp, cfg, variant)
    t = _run_variant(TorchEngine, tcore, tp, tcfg, variant, device="cpu")
    if variant == "prefix_cache":
        assert j[0].prefix_cache.stats["cow_splits"] > 0
        assert dict(t[0].prefix_cache.stats) == \
            dict(j[0].prefix_cache.stats)
    _assert_same_run(j, t)


def test_server_workload_matches_jax(models):
    """runtime.server(...).run(workload): the port's front door over a
    Poisson workload of two SLO classes, async with prefetch."""
    cfg, tcfg, jp, tp = models
    from repro.core import PrefetchConfig
    wl = dict(num_requests=6, arrival="poisson", rate=2e4, seed=0,
              vocab=(3, 250))
    tenants = [("latency", (5, 12)), ("batch", (5, 20))]

    def serve(runtime, params, c, pf, workload_cls, tenant_cls, **kw):
        server = runtime.server(c, params, max_batch=2, block_size=8,
                                num_local_slots=10, scheduler="fair",
                                mode="async", prefetch=pf,
                                fidelity_policy="slo", **kw)
        sampled = _record_sampled_logits(server.engine)
        stats = server.run(workload_cls(**wl, tenants=tuple(
            tenant_cls(n, slo=n, prompt_len=pl, max_new_tokens=6)
            for n, pl in tenants)))
        return [h.tokens for h in server.handles], stats, server, sampled

    jt, js, jsrv, jlog = serve(HarvestRuntime({1: 64 * MiB}), jp, cfg,
                               PrefetchConfig(), Workload, TenantSpec)
    tt, ts, tsrv, tlog = serve(tcore.HarvestRuntime({1: 64 * MiB}), tp,
                               tcfg, tcore.PrefetchConfig(),
                               tserving.Workload, tserving.TenantSpec,
                               device="cpu")
    assert tt == jt and all(len(x) == 6 for x in tt)
    _check_sampled_logits(jlog, tlog)
    assert ts.clock_s == pytest.approx(js.clock_s, rel=1e-9)
    assert dict(tsrv.engine.kv_mgr.stats) == dict(jsrv.engine.kv_mgr.stats)
    ts.check_clock_identity()


def test_cli_runs_on_the_cpu_when_asked(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--scheduler", "fair",
        "--num-requests", "3", "--max-new-tokens", "4",
        "--fidelity-policy", "slo", "--mode", "async"])
    serve.main()
    out = capsys.readouterr().out
    assert "3/3 requests served" in out


def test_entry_points_default_to_cuda(models):
    """Without a card, every entry point called without device='cpu'
    raises instead of running on the CPU; with one, they pick the card."""
    cfg, tcfg, jp, tp = models
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.HarvestRuntime({1: MiB}).server(tcfg, tp)
    sys_argv = sys.argv
    try:
        sys.argv = ["serve", "--num-requests", "1"]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main()
    finally:
        sys.argv = sys_argv


def test_engine_rejects_params_on_another_device(models):
    cfg, tcfg, jp, tp = models
    meta = {k: v for k, v in tp.items()}
    meta["final_norm"] = torch.empty_like(tp["final_norm"], device="meta")
    with pytest.raises(ValueError, match="params live on"):
        TorchEngine(tcfg, meta, device="cpu")


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port in a fresh interpreter: neither jax
    nor any module of the JAX package may load."""
    src = Path(__file__).resolve().parent.parent / "src"
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'ml_dtypes', 'repro.'))\n"
        "             or m == 'repro')\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "new = {'repro_torch.data.pipeline', 'repro_torch.train.optim',\n"
        "       'repro_torch.train.loop', 'repro_torch.train.checkpoint',\n"
        "       'repro_torch.launch.train'}\n"
        "assert new <= set(names), new - set(names)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stdout + res.stderr


def test_smoke_and_tools_import_neither_jax_nor_repro():
    """``chip_smoke.py`` and the timing tools run on a machine without JAX:
    none of them may import jax, ml_dtypes or the JAX package."""
    import ast
    root = Path(__file__).resolve().parent.parent
    files = [root / "chip_smoke.py", *sorted((root / "tools").glob("*.py"))]
    assert len(files) >= 3, files
    for f in files:
        names = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module)
        bad = sorted(n for n in names if n.split(".")[0] in
                     ("jax", "jaxlib", "ml_dtypes", "repro"))
        assert not bad, (f.name, bad)
