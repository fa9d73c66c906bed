"""The port's dry run (``launch.specs``, ``launch.op_analysis``,
``launch.dryrun``, ``launch.audit``) and prefill on a mesh, held to the
JAX package.

The JAX side runs in one subprocess, this file run as a script
(``--jax-reference``): ``repro.launch.dryrun`` imported first, which sets
its 512-device flag before jax loads.  It writes the global shapes and
dtypes of ``abstract_batch`` and ``abstract_decode_state`` for every
(arch, shape) pair on both production meshes (``ShapeDtypeStruct``s;
nothing is compiled), ``model_flops`` for every pair, and the jitted
sharded ``prefill`` of reduced yi-6b and phi-tiny-moe in f32 on a (2, 2)
mesh of Auto axes over four of its devices.  At the same time one launch
of 4 gloo ranks on the CPU runs the port's ``prefill(..., rules)`` on the
same weights and rows, and a counted ``train_step(..., rules)`` whose
collectives are held to the same step's count under torch's fake process
group (``launch.dryrun.fake_world``) in this process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

AXES = ("data", "model")
SEQ = 16
ROWS = 4
PREFILL_ARCHS = ("yi-6b", "phi-tiny-moe")
#: prefill on a mesh against JAX's sharded prefill, f32: logits and KV
PREFILL_TOL = 1e-5
TIMEOUT_S = 300


def _flat(tree, prefix=""):
    """{dotted field path: leaf} of nested NamedTuples, tuples and dicts
    (None leaves dropped)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("."): tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _reduced(arch, family_jax: bool):
    if family_jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return get_config(arch).reduced()


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size,
                            size=(ROWS, SEQ)).astype(np.int32),
        positions=np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                  (ROWS, SEQ)).copy())


def _bits(a):
    """A leaf as numpy, bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tree_flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tree_unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# the JAX reference (this file run as a script, in its own process)
# ---------------------------------------------------------------------------


def _jax_reference(inputs_path, out_json, out_npz):
    import repro.launch.dryrun as JD        # sets the 512-device flag
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.configs import INPUT_SHAPES, dryrun_pairs, get_config
    from repro.launch import specs as JS
    from repro.launch.mesh import make_production_mesh, make_rules
    from repro.models import model as JM

    out = {"shapes": {}, "model_flops": {}}
    for kind in ("pod", "multipod"):
        rules = make_rules(make_production_mesh(multi_pod=kind == "multipod"))
        for arch, name in dryrun_pairs():
            cfg, shape = get_config(arch), INPUT_SHAPES[name]
            if shape.kind == "decode":
                tree = JS.abstract_decode_state(cfg, shape, rules)
            else:
                tree = JS.abstract_batch(cfg, shape,
                                         with_labels=shape.kind == "train")
            out["shapes"][f"{kind}/{arch}/{name}"] = {
                k: [list(v.shape), _dtype_name(v.dtype)]
                for k, v in _flat(tree).items()}
            out["model_flops"][f"{arch}/{name}"] = JD.model_flops(cfg, shape)

    inp = dict(np.load(inputs_path))
    mesh = jax.make_mesh((2, 2), AXES, devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = make_rules(mesh)
    arrays = {}
    for arch in PREFILL_ARCHS:
        cfg = _reduced(arch, True)
        # the bf16 weights widened to f32 (exact), as the port's ranks
        params = jax.tree.map(
            lambda a: jnp.asarray(a.view(ml_dtypes.bfloat16)
                                  if a.dtype == np.uint16 else a
                                  ).astype(jnp.float32),
            _tree_unflat(inp, f"{arch}/params/"))
        batch = {k: jnp.asarray(inp[f"{arch}/batch/{k}"])
                 for k in ("tokens", "positions")}
        logits, fo = jax.jit(lambda p, b: JM.prefill(p, b, cfg, rules))(
            params, batch)
        arrays[f"{arch}/logits"] = np.asarray(logits)
        arrays[f"{arch}/k"] = np.asarray(fo.kv[0])
        arrays[f"{arch}/v"] = np.asarray(fo.kv[1])
    Path(out_json).write_text(json.dumps(out))
    np.savez(out_npz, **arrays)


def _build_inputs(path):
    import jax

    from repro.models import model as JM
    flat = {}
    for i, arch in enumerate(PREFILL_ARCHS):
        cfg = _reduced(arch, True)
        jp = jax.tree.map(_bits, JM.init_params(jax.random.PRNGKey(i), cfg))
        flat.update(_tree_flat(jp, f"{arch}/params/"))
        for k, v in _batch(cfg, 40 + i).items():
            flat[f"{arch}/batch/{k}"] = v
    np.savez(path, **flat)


# ---------------------------------------------------------------------------
# the port (4 gloo ranks)
# ---------------------------------------------------------------------------


def _counted_train_step(cfg, rules, params, batch):
    """The collectives and launches of one counted ``train_step`` on this
    rank."""
    from repro_torch.launch.op_analysis import count
    from repro_torch.train.optim import adamw_init, train_step

    _, c = count(lambda p, o, b: train_step(p, o, b, cfg, rules),
                 (params, adamw_init(params), batch))
    return dict(collectives=c.collectives, launches=c.launches(),
                dot_flops=c.dot_flops, hbm_bytes=c.hbm_bytes)


def _port_ranks(rank, world, inputs_path):
    """Prefill on the mesh for each of ``PREFILL_ARCHS`` (the logits and
    KV of this rank's rows), and a counted train step of reduced
    phi-tiny-moe."""
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy, shard_train
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import model as TM

    inp = dict(np.load(inputs_path))
    rules = make_rules(Mesh((2, 2), AXES))
    res = {"coords": rules.mesh.coords}
    for arch in PREFILL_ARCHS:
        cfg = _reduced(arch, False)
        bf16 = params_from_numpy(_tree_unflat(inp, f"{arch}/params/"), cfg,
                                 "cpu")
        full = _tree_unflat({k: v.float() for k, v in
                             _tree_flat(bf16, "").items()}, "")
        p, _ = shard_train(full, None, cfg, rules)
        batch = {k: torch.from_numpy(inp[f"{arch}/batch/{k}"])
                 for k in ("tokens", "positions")}
        logits, out = TM.prefill(p, batch, cfg, rules)
        res[arch] = dict(logits=logits.numpy(), k=out.kv[0].numpy(),
                         v=out.kv[1].numpy())
        if arch == "phi-tiny-moe":
            labels = torch.from_numpy(inp[f"{arch}/batch/tokens"]).roll(-1, 1)
            # in the weights' own bf16, the kernels' path on the card too
            res["train"] = _counted_train_step(
                cfg, rules, shard_train(bf16, None, cfg, rules)[0],
                dict(batch, labels=labels))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's shapes and flops, JAX's prefill arrays, each rank's
    results)."""
    from repro_torch.launch.mesh import launch

    tmp = tmp_path_factory.mktemp("dryrun")
    inputs = tmp / "inputs.npz"
    out_json, out_npz = tmp / "jax.json", tmp / "jax.npz"
    _build_inputs(inputs)
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, __file__, "--jax-reference", str(inputs),
         str(out_json), str(out_npz)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch(_port_ranks, 4, (str(inputs),), timeout=TIMEOUT_S)
    finally:
        log, _ = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, log[-4000:]
    return json.loads(out_json.read_text()), dict(np.load(out_npz)), ranks


@pytest.fixture
def fake_world():
    """``launch.dryrun.fake_world``, left when the test ends."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world as join
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# specs against the JAX package's
# ---------------------------------------------------------------------------


def _port_rules(kind):
    from repro_torch.launch.mesh import Mesh, make_rules
    if kind == "pod":
        return make_rules(Mesh((16, 16), AXES))
    return make_rules(Mesh((2, 16, 16), ("pod",) + AXES))


@pytest.mark.parametrize("kind", ["pod", "multipod"])
def test_abstract_inputs_match_jax(runs, kind):
    from repro_torch.configs import INPUT_SHAPES, dryrun_pairs, get_config
    from repro_torch.launch import specs

    want = runs[0]["shapes"]
    rules = _port_rules(kind)
    pairs = dryrun_pairs()
    assert len(pairs) == 34
    for arch, name in pairs:
        cfg, shape = get_config(arch), INPUT_SHAPES[name]
        if shape.kind == "decode":
            tree = specs.abstract_decode_state(cfg, shape, rules)
        else:
            tree = specs.abstract_batch(cfg, shape,
                                        with_labels=shape.kind == "train")
        got = {k: [list(v.shape), _dtype_name(v.dtype)]
               for k, v in _flat(tree).items()}
        assert all(v.device.type == "meta" for v in _flat(tree).values())
        assert got == want[f"{kind}/{arch}/{name}"], (kind, arch, name)


def test_model_flops_match_jax(runs):
    from repro_torch.configs import INPUT_SHAPES, dryrun_pairs, get_config
    from repro_torch.launch.dryrun import model_flops

    want = runs[0]["model_flops"]
    for arch, name in dryrun_pairs():
        assert model_flops(get_config(arch), INPUT_SHAPES[name]) \
            == want[f"{arch}/{name}"], (arch, name)


@pytest.mark.parametrize("arch", ["qwen2-moe", "yi-6b", "xlstm-1.3b"])
def test_harvest_record_matches_jax_runtime(arch):
    from repro.configs import get_config as j_get_config
    from repro.core.runtime import HarvestRuntime
    from repro.core.tiers import H100_NVLINK, Tier

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import harvest_record

    rec = harvest_record(get_config(arch), 0.25)
    cfg = j_get_config(arch)
    rt = HarvestRuntime(hardware=H100_NVLINK)
    from repro.core.tiers import expert_bytes, kv_block_bytes
    units = {}
    if cfg.moe is not None:
        units["expert"] = expert_bytes(cfg)
    if cfg.has_kv_cache:
        units["kv_block_16"] = kv_block_bytes(cfg, 16)
    assert set(rec) == {"hardware", "peer_fraction", *units}
    assert rec["hardware"] == H100_NVLINK.name and rec["peer_fraction"] == 0.25
    for name, nbytes in units.items():
        peer = rt.transfers.transfer(name, nbytes, Tier.PEER_HBM,
                                     Tier.LOCAL_HBM, client="dryrun").seconds
        host = rt.transfers.transfer(name, nbytes, Tier.HOST_DRAM,
                                     Tier.LOCAL_HBM, client="dryrun").seconds
        assert rec[name] == {"bytes": nbytes, "peer_reload_s": peer,
                             "host_reload_s": host,
                             "peer_speedup": host / peer}, name


# ---------------------------------------------------------------------------
# prefill on a mesh
# ---------------------------------------------------------------------------


def test_ranks_are_the_mesh(runs):
    assert [r["coords"] for r in runs[2]] == [
        {"data": i, "model": j} for i in range(2) for j in range(2)]


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_on_a_mesh_matches_jax(runs, arch):
    """Each rank's rows (its data index's half of the batch) of JAX's
    sharded prefill: the last-token logits and the stacked k and v."""
    jax_out = runs[1]
    for rank, res in enumerate(runs[2]):
        i = res["coords"]["data"]
        rows = slice(i * ROWS // 2, (i + 1) * ROWS // 2)
        got = res[arch]
        for name, want in (("logits", jax_out[f"{arch}/logits"][rows]),
                           ("k", jax_out[f"{arch}/k"][:, rows]),
                           ("v", jax_out[f"{arch}/v"][:, rows])):
            assert got[name].shape == want.shape, (arch, rank, name)
            np.testing.assert_allclose(got[name], want, rtol=PREFILL_TOL,
                                       atol=PREFILL_TOL,
                                       err_msg=f"{arch} rank {rank} {name}")


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_prefill_on_a_mesh_refuses_recurrent_families(fake_world, arch):
    """The recurrent families' prefill on the production mesh, which
    raised NotImplementedError before they had a pass on a mesh, runs on
    ``meta`` tensors in a fake world of 256 ranks: the logits, Zamba2's
    KV and the final states of the rank's 2 of 32 rows (the batch over
    ``data``)."""
    from repro_torch.models import model as TM

    fake_world(256)
    cfg = _reduced(arch, False)
    params = TM.abstract_params(cfg, _port_rules("pod"))
    b = 32
    batch = {"tokens": torch.empty((b, SEQ), dtype=torch.int32,
                                   device="meta"),
             "positions": torch.empty((b, SEQ), dtype=torch.int32,
                                      device="meta")}
    logits, out = TM.prefill(params, batch, cfg, _port_rules("pod"))
    assert logits.shape == (b // 16, cfg.vocab_size)
    assert (out.kv is not None) == (arch == "zamba2-7b")
    if out.kv is not None:
        assert out.kv[0].shape[1] == b // 16
    lead = [1] if arch == "zamba2-7b" else [2] * 4 + [1] * 4
    leaves = list(out.states) if arch == "zamba2-7b" else \
        [t for st in out.states for t in st]
    assert [t.shape[d] for t, d in zip(leaves, lead * len(leaves))] == \
        [b // 16] * len(leaves)


def test_decode_state_holds_the_rank_rows(fake_world):
    """xlstm-1.3b's ``decode_32k`` step on the pod: the rank's recurrent
    states are its 8 of the 128 rows (the batch over ``data``, 16), 1/16
    of the global states' bytes, as ``bridge.shard_decode`` cuts them and
    ``serve_step(rules)`` runs them; the record's peak a rank (20.48 GiB
    where every rank held every row's states: 270.54) fits the card, under
    a third of the global states alone (84.23 GiB)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import run_one

    fake_world(256)
    cfg, shape = get_config("xlstm-1.3b"), INPUT_SHAPES["decode_32k"]
    rules = _port_rules("pod")

    def nbytes(states):
        return sum(t.numel() * t.element_size()
                   for st in states for t in st)

    whole = specs.abstract_decode_state(cfg, shape, rules).states
    _, (_, state) = specs.build_step(cfg, shape, rules)
    assert state.tokens.shape == (shape.global_batch,)
    assert all(t.shape[d] == shape.global_batch // 16
               for st, d in zip(state.states, (2, 1)) for t in st)
    assert nbytes(state.states) * 16 == nbytes(whole)
    rec = run_one("xlstm-1.3b", "decode_32k", "pod")
    assert rec["ok"], rec.get("error")
    assert rec["mem"]["total_bytes"] < nbytes(whole) / 3
    assert rec["mem"]["fits"]


# ---------------------------------------------------------------------------
# the counts: meta against a real run
# ---------------------------------------------------------------------------


def _reduced_inputs(arch, device):
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(_reduced(arch, False), num_layers=2)
    if device == "meta":
        params = TM.abstract_params(cfg)
    else:
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 7).items()}
    b["labels"] = b["tokens"].roll(-1, 1)
    return cfg, params, {k: v.to(device) for k, v in b.items()}


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
@pytest.mark.parametrize("step", ["train", "prefill"])
def test_meta_counts_equal_a_cpu_run(arch, step):
    """The same step counted on ``meta`` tensors and run on the CPU: the
    ``aten`` flops and bytes exactly, and each kernel's calls and cost
    (reported at its wrapper by its cost function; on the CPU its plain
    version's ops are left out of the ``aten`` counts)."""
    from repro_torch.kernels.flash_attention.ops import (
        prefill_attention_bwd_cost, prefill_attention_cost)
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import model as TM
    from repro_torch.train.optim import adamw_init, train_step

    counts = {}
    for device in ("meta", "cpu"):
        cfg, params, batch = _reduced_inputs(arch, device)
        if step == "train":
            fn = lambda p, o, b: train_step(p, o, b, cfg)   # noqa: E731
            args = (params, adamw_init(params), batch)
        else:
            fn = lambda p, b: TM.prefill(p, b, cfg)         # noqa: E731
            args = (params, batch)
        with torch.no_grad() if step == "prefill" else torch.enable_grad():
            _, counts[device] = count(fn, args)
    meta, cpu = counts["meta"], counts["cpu"]
    assert meta.dot_flops > 0 and meta.hbm_bytes > 0
    assert (meta.dot_flops, meta.hbm_bytes) == (cpu.dot_flops, cpu.hbm_bytes)
    assert meta.ops == cpu.ops
    assert meta.kernels == cpu.kernels
    L, nq, nkv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    shape = (ROWS, SEQ, SEQ, nq, nkv, hd, 2)          # bf16 weights
    k4 = meta.kernels["prefill_attention"]
    if step == "train":      # the pass and the recompute, then the backward
        fwd = prefill_attention_cost(*shape, lse=True)
        bwd = prefill_attention_bwd_cost(*shape)
        assert k4 == dict(launches=2 * L, flops=2 * L * fwd.flops,
                          bytes=2 * L * fwd.nbytes, dtype="bfloat16")
        assert meta.kernels["prefill_attention_bwd"] == dict(
            launches=L, flops=L * bwd.flops, bytes=L * bwd.nbytes,
            dtype="bfloat16")
    else:
        fwd = prefill_attention_cost(*shape)
        assert k4 == dict(launches=L, flops=L * fwd.flops,
                          bytes=L * fwd.nbytes, dtype="bfloat16")
    moe = {n for n in meta.kernels if n.startswith("moe_ffn")}
    assert moe == (set() if cfg.moe is None else
                   {"moe_ffn_train", "moe_ffn_bwd"} if step == "train"
                   else {"moe_ffn"})


def test_train_step_memory_split():
    """The peak's split: the parameters and moments are arguments updated
    in place (aliased outputs), and the temporaries are the rest."""
    from repro_torch.launch.op_analysis import count
    from repro_torch.train.optim import adamw_init, train_step

    cfg, params, batch = _reduced_inputs("yi-6b", "meta")
    opt = adamw_init(params)
    _, c = count(lambda p, o, b: train_step(p, o, b, cfg),
                 (params, opt, batch))
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _flat(tree).values())

    m = c.mem
    assert m["argument_bytes"] == nbytes((params, opt, batch))
    # the step count is a new tensor; the rest is updated in place
    assert m["alias_bytes"] == nbytes((params, opt.mu, opt.nu))
    assert m["temp_bytes"] > 0
    assert m["total_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                                + m["temp_bytes"] - m["alias_bytes"])


def test_collectives_under_the_fake_group_equal_gloo(runs, fake_world):
    """Rank r's counted train step on the (2, 2) mesh under torch's fake
    process group (``meta`` tensors) against rank r's real step over 4
    gloo ranks on the CPU, bf16 weights: each kind's calls and
    ring-model bytes exactly, and the kernels' launches and the ``aten``
    counts too."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import Mesh, make_rules
    from repro_torch.models import model as TM
    from repro_torch.configs.base import InputShape

    cfg = _reduced("phi-tiny-moe", False)
    for rank, res in enumerate(runs[2]):
        fake_world(4, rank)
        rules = make_rules(Mesh((2, 2), AXES))
        batch = specs.abstract_batch(cfg, InputShape("t", SEQ, ROWS, "train"),
                                     with_labels=True)
        got = _counted_train_step(cfg, rules, TM.abstract_params(cfg, rules),
                                  batch)
        assert got == res["train"], rank
        assert sum(v["calls"] for v in got["collectives"].values()) > 0


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def _record_counts(rec):
    return {k: rec[k] for k in ("mem", "cost", "collectives")}


def test_rank_0_stands_for_rank_255(fake_world):
    from repro_torch.launch.dryrun import run_one

    first = run_one("phi-tiny-moe", "prefill_32k", "pod", rank=0)
    last = run_one("phi-tiny-moe", "prefill_32k", "pod", rank=255)
    assert first["ok"] and last["ok"], (first.get("error"), last.get("error"))
    assert sum(last["collectives"]["counts"].values()) > 0
    assert _record_counts(first) == _record_counts(last)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("yi-6b", "decode_32k", "pod"),
    ("phi-tiny-moe", "decode_32k", "multipod"),
    ("musicgen-medium", "decode_32k", "pod"),
    ("xlstm-1.3b", "decode_32k", "pod"),
    ("h2o-danube-3-4b", "long_500k", "multipod"),
])
def test_run_one_records(fake_world, arch, shape, mesh):
    from repro_torch.launch.dryrun import run_one

    rec = run_one(arch, shape, mesh)
    assert rec["ok"], rec.get("error")
    assert rec["devices"] == (512 if mesh == "multipod" else 256)
    assert set(rec) >= {"mem", "cost", "collectives", "roofline", "harvest"}
    r = rec["roofline"]
    assert r["hardware"] == "h100-nvlink-2gpu"
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert rec["mem"]["total_bytes"] >= rec["mem"]["argument_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    json.dumps(rec)
    kv = arch != "xlstm-1.3b"
    assert ("paged_decode_partials" in rec["cost"]["kernels"]) == kv


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_run_one_refuses_hybrid_on_a_mesh(fake_world, shape):
    """zamba2-7b's training and prefill on the pod mesh, which the dry run
    recorded as NotImplementedError before the hybrid family had a pass
    on a mesh, now give ``ok`` records: the Mamba2 layers' FSDP gathers
    counted (two a layer in training: the pass and its recompute; one in
    prefill) and K4 at the shared block's 13 uses.  Prefill's
    reduce-scatters are tensor parallelism's alone: the shared block's
    two row-parallel outputs at each of its 13 uses, the
    vocabulary-parallel embedding and each of the 81 Mamba2 layers'
    row-parallel ``out_proj`` (its 112 heads split by 7 a rank); training
    adds the FSDP gradients'."""
    from repro_torch.launch.dryrun import run_one

    rec = run_one("zamba2-7b", shape, "pod")
    assert rec["ok"], rec.get("error")
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] > 81
    tp = 2 * 13 + 1 + 81
    if shape == "prefill_32k":
        assert counts["reduce-scatter"] == tp
    else:
        assert counts["reduce-scatter"] > tp
    assert "prefill_attention" in rec["cost"]["kernels"]


def test_run_one_refuses_global_dispatch_on_a_mesh(fake_world):
    """What still raises on a mesh: mixtral-8x7b's 8 experts do not divide
    over ``model`` (16), so its training takes the JAX package's global
    dispatch over every rank's rows, which is not ported."""
    from repro_torch.launch.dryrun import run_one

    rec = run_one("mixtral-8x7b", "train_4k", "pod")
    assert not rec["ok"]
    assert rec["error"].startswith(
        "NotImplementedError: 8 experts over 16 ranks with the batch split: "
        "the global dispatch"), rec["error"]


_DEEP_GRAPH = """
import threading, torch
from repro_torch.launch.op_analysis import count

def step(x):
    y = x
    for _ in range(20000):
        y = torch.tanh(y)
    return torch.autograd.grad(y.sum(), x)[0]

def run():
    count(step, (torch.zeros(4, device="meta", requires_grad=True),))
    print("counted")

count(lambda: None)     # the lazy imports, on the main thread's stack
threading.stack_size(1024 * 1024)
t = threading.Thread(target=run)
t.start()
t.join()
"""


def test_count_frees_a_deep_graph():
    """A backward pass over a long chain of graph nodes (an sLSTM block's
    tokens) counted from a thread of 1 MiB of stack: while the counter
    read each node's name, each node and its Python wrapper held each
    other, and the chain, freed by the cyclic collector, was freed one node
    inside the next, which overran the thread's stack (a segmentation
    fault at 20,000 nodes here, at 50,000 on a main thread's 8 MiB); the
    counter reads no node now."""
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    run = subprocess.run([sys.executable, "-c", _DEEP_GRAPH], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "counted" in run.stdout, \
        (run.returncode, run.stderr[-2000:])


_FIRST_COUNT = """
import dataclasses, torch
from repro_torch.configs import get_config
from repro_torch.launch.op_analysis import count
from repro_torch.models import model as TM
from repro_torch.train.optim import adamw_init, train_step

cfg = dataclasses.replace(get_config("yi-6b").reduced(), num_layers=2)
params = TM.abstract_params(cfg)
batch = {k: torch.empty((2, 16), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels", "positions")}
print([count(lambda p, o, b: train_step(p, o, b, cfg),
             (params, adamw_init(params), batch))[1].mem["total_bytes"]
       for _ in range(2)])
"""


def test_first_count_of_a_process_is_not_inflated():
    """The first checkpointed backward of a process imports modules
    lazily, and the exceptions caught on the way hold the caller's frames
    (and tensors) in reference cycles: a fresh process's first count of a
    training step read a higher peak than the same step counted again
    (22,921,000 against 22,822,308 bytes here) until ``count`` made those
    imports first."""
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    run = subprocess.run([sys.executable, "-c", _FIRST_COUNT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    first, second = json.loads(run.stdout.strip().splitlines()[-1])
    assert first == second


def test_gloo_count_holds_the_reduce_scatter_operand(fake_world):
    """``count(..., gloo=True)``: a reduce-scatter holds a copy of its
    operand while it runs, as gloo's does on the ranks that share one card,
    so the peak rises by the operand where the reduce-scatter is the peak;
    the ops and the collectives are counted the same either way."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.launch.op_analysis import count

    fake_world(4)
    group = dist.new_group([0, 1])
    x = torch.empty((1024, 256), device="meta", requires_grad=True)

    def step(x):
        y = collectives.gather_over([x], [0], group)[0]
        return torch.autograd.grad(y.float().sum(), x)[0]

    (_, nccl), (_, gloo) = (count(step, (x,), gloo=g) for g in (False, True))
    operand = 2 * 1024 * 256 * 4        # the gathered gradient, f32
    assert gloo.mem["total_bytes"] == nccl.mem["total_bytes"] + operand
    assert gloo.collectives == nccl.collectives
    assert gloo.ops == nccl.ops


def test_first_count_of_a_process_may_run_under_no_grad():
    """A process's first count makes the lazy imports with a checkpointed
    backward of its own, which needs grad even where the count is called
    under ``no_grad`` (a prefill's)."""
    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    run = subprocess.run([sys.executable, "-c", (
        "import torch\n"
        "from repro_torch.launch.op_analysis import count\n"
        "with torch.no_grad():\n"
        "    _, c = count(lambda x: x + 1, (torch.ones(2),))\n"
        "print(c.mem['total_bytes'])\n")], env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.split() == ["16"]


def test_audit_report_names_ops_and_sites():
    from repro_torch.launch.audit import report
    from repro_torch.launch.op_analysis import count
    from repro_torch.train.optim import adamw_init, train_step

    cfg, params, batch = _reduced_inputs("phi-tiny-moe", "meta")
    _, c = count(lambda p, o, b: train_step(p, o, b, cfg),
                 (params, adamw_init(params), batch))
    text = report(c, 8)
    assert "memory/rank" in text and "moe_ffn_train" in text
    sites = {site for _, site in c.ops}
    assert "models.layers.rms_norm" in sites
    assert "backward" in sites
    assert "train.optim.adamw_update" in sites


# ---------------------------------------------------------------------------
# each wrapper's meta branch
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_cases():
    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.harvest_copy import ops as H
    from repro_torch.kernels.moe_ffn import ops as K7
    from repro_torch.kernels.paged_attention import ops as K1

    bf, i32 = torch.bfloat16, torch.int32
    b, s, nq, nkv, hd = 2, 24, 8, 2, 16
    q, k = _meta(b, s, nq, hd, dtype=bf), _meta(b, s, nkv, hd, dtype=bf)
    pos = _meta(b, s, dtype=i32)
    e, c, d, f = 4, 16, 32, 24
    xd = _meta(e, c, d, dtype=bf)
    w = (_meta(e, d, f, dtype=bf), _meta(e, d, f, dtype=bf),
         _meta(e, f, d, dtype=bf))
    saved = K7.moe_ffn_train(xd, *w)[1]
    pool = _meta(10, 12)
    ids = np.asarray([1, 3, 4], np.int32)
    vals, scales = _meta(3, 12, dtype=torch.int8), _meta(3, 1)
    return [
        ("paged_decode_partials",
         lambda: K1.paged_decode_partials(
             _meta(3, 8, 16), _meta(6, 4, 2, 16), _meta(6, 4, 2, 16),
             _meta(6, dtype=i32), _meta(6, dtype=i32), _meta(3, dtype=i32),
             scale=0.25, sliding_window=8),
         [(3, 2, 4), (3, 2, 4), (3, 2, 4, 16)],
         K1.paged_decode_partials_cost(3, 8, 2, 16, 6, 4, sliding_window=8)),
        ("prefill_attention",
         lambda: F.prefill_attention(q, k, k, pos, pos, attention_chunk=8),
         [tuple(q.shape)],
         F.prefill_attention_cost(b, s, s, nq, nkv, hd, 2,
                                  attention_chunk=8)),
        ("prefill_attention",
         lambda: F.PrefillAttention.apply(q, k, k, pos, pos, None, None,
                                          None),
         [tuple(q.shape)],
         F.prefill_attention_cost(b, s, s, nq, nkv, hd, 2, lse=True)),
        ("prefill_attention_bwd",
         lambda: F.prefill_attention_bwd(q, k, k, q, _meta(b, nq, s), q, pos,
                                         pos),
         [tuple(q.shape), tuple(k.shape), tuple(k.shape)],
         F.prefill_attention_bwd_cost(b, s, s, nq, nkv, hd, 2)),
        ("moe_ffn", lambda: K7.moe_ffn(xd, *w), [(e, c, d)],
         K7.moe_ffn_cost(e, c, d, f, 2)),
        ("moe_ffn_train", lambda: K7.moe_ffn_train(xd, *w)[0], [(e, c, d)],
         K7.moe_ffn_train_cost(e, c, d, f, 2)),
        ("moe_ffn_bwd", lambda: K7.moe_ffn_bwd_saved(saved, xd),
         [(e, c, d), (e, d, f), (e, d, f), (e, f, d)],
         K7.moe_ffn_bwd_cost(e, c, d, f, 2, saved=True)),
        ("moe_ffn_bwd", lambda: K7.moe_ffn_bwd(xd, *w, xd),
         [(e, c, d), (e, d, f), (e, d, f), (e, f, d)],
         K7.moe_ffn_bwd_cost(e, c, d, f, 2, saved=False)),
        ("quantize_blocks", lambda: H.quantize_blocks(pool, ids),
         [(3, 12), (3, 1)], H.quantize_blocks_cost(3, 12, 12, 4)),
        ("dequantize_blocks",
         lambda: H.dequantize_blocks(pool, vals, scales, ids), [(10, 12)],
         H.dequantize_blocks_cost(3, 12, 12, 4)),
        ("gather_blocks", lambda: H.gather_blocks(pool, ids), [(3, 12)],
         H.gather_blocks_cost(3, 48)),
        ("copy_blocks",
         lambda: H.copy_blocks(pool, _meta(8, 12), ids, [0, 1, 2]),
         [(8, 12)], H.copy_blocks_cost(3, 48)),
    ]


@pytest.mark.parametrize("i", range(12))
def test_wrapper_meta_branch_reports_its_cost(i):
    from repro_torch.launch.op_analysis import count

    name, call, shapes, cost = _wrapper_cases()[i]
    out, c = count(call)
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    assert [tuple(t.shape) for t in outs] == shapes, name
    assert all(t.device.type == "meta" for t in outs)
    assert c.kernels == {name: dict(launches=1, flops=float(cost.flops),
                                    bytes=float(cost.nbytes),
                                    dtype=_dtype_name(cost.dtype))}, name
    # the outputs' allocation is the kernel's, not an aten op's traffic
    assert c.hbm_bytes == 0 and c.dot_flops == 0, name


def test_row_parallel_counts_the_cards_bf16_product():
    """``layers.row_parallel`` of bf16 operands on ``meta`` counts the
    card's ops: one bf16 product with an f32 output (its flops, the bf16
    operands read once and the f32 output written), no widened copy of
    an operand, and a backward of two bf16 products; on the CPU the same
    call widens the operands and returns the same shape and dtype."""
    from repro_torch.launch.op_analysis import count
    from repro_torch.models.layers import row_parallel

    m, n, h, d = 6, 4, 8, 5

    def step(a, w):
        y = row_parallel(a, w, 2)
        y.to(torch.bfloat16).float().sum().backward()
        return y

    a, w = (torch.empty(shape, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
            for shape in ((2, m // 2, n, h), (n, h, d)))
    y, c = count(step, (a, w))
    assert y.dtype == torch.float32 and y.shape == (2, m // 2, d)
    assert a.grad.dtype == w.grad.dtype == torch.bfloat16
    mm = {site: v for (op, site), v in c.ops.items() if op == "mm"}
    k = n * h
    fwd = [v for site, v in mm.items() if site != "models.layers.backward"]
    assert fwd == [[1, 2 * m * k * d, 2 * (m * k + k * d) + 4 * m * d]]
    assert mm["models.layers.backward"][:2] == [2, 2 * 2 * m * k * d]
    widened = [v for (op, site), v in c.ops.items()
               if op == "_to_copy" and site == "models.layers.row_parallel"]
    assert not widened
    cpu = row_parallel(torch.ones((2, 3, n, h), dtype=torch.bfloat16),
                       torch.ones((n, h, d), dtype=torch.bfloat16), 2)
    assert cpu.dtype == torch.float32 and torch.all(cpu == k)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-reference"]:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    _jax_reference(*sys.argv[2:5])
