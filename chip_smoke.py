"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel in ``src/repro_torch/csrc`` with nvcc (in parallel),
     print each kernel's registers and spills, and the tensor-core (HMMA)
     instructions in the SASS of prefill attention's kernels; the bf16
     kernel must have some and spill nothing;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the full-width serving paths give it and at edge cases, and
     time kernel, plain version, library call and bound (paged decode also
     at nemotron-4-15b's, command-r-35b's, llama4-maverick-400b-a17b's,
     qwen2-vl-72b's and zamba2-7b's full-width shapes, GQA groups of 6,
     8, 5, 8 and 1 (zamba2's MHA at head dim 112),
     at a card-filling yi-6b
     pool of 65,536 slots holding 64 short contexts, and at Llama-4's heads
     with its 8,192-token attention chunk, rows on both sides of the
     boundary; prefill attention at 40-, 1,032- and 6,000-token prompts,
     an 8,800-token Llama-4 prompt past its chunk, Command-R's, Nemotron's,
     DBRX's and zamba2-7b's smoke prompts and qwen2-vl-72b's 1,024 prefix
     positions ahead of one, with a sliding window, an attention chunk and
     a logit softcap, in bf16 on the tensor cores and f32 on the CUDA
     cores, the kernel that ran read from the trace; quantize-on-demote and
     dequantize-on-reload on f32, bf16 and f16 pools, timed at each path's
     demoted block, one quantize call's trace holding its one kernel and
     nothing else, the dequantize's kernel alone and as the engine calls
     it; the block movers as the engine calls them (the ids in their
     launches), split into their kernels' own time and any host-to-device
     copy of their ids (none), beside the library calls with device ids and
     with host ids; the expert FFN at a decode and a prefill shape, with
     the experts it skipped for want of a token counted on the card; at
     Llama-4's and DBRX's decode shapes inside their paths, below);
     prefill attention's backward (bf16 on wgmma fed by TMA, f32 on the
     CUDA cores) against its plain version at danube's 8,192-token
     training sequence, yi-6b's heads at 2,048 tokens, Llama-4's heads
     across its chunk, zamba2-7b's MHA at hd 112 and a small f32 case,
     each bf16 shape's backward twice and bit-identical, the kernels that
     ran read from a trace, the forward's LSE against the plain LSE, and
     the forward with its LSE and the backward timed at the training
     shape beside ``scaled_dot_product_attention`` forward, forward plus
     backward, and backward alone;
  4. reduced yi-6b, qwen2-moe, h2o-danube-3-4b (prompts past its 64-token
     window), nemotron-4-15b at 12 / 2 heads (its GQA group of 6),
     Llama-4 at 4 layers with its dense/MoE interleaving (prompts past its
     64-token chunk), Command-R at 4 layers (parallel blocks), qwen2-vl-72b
     (M-RoPE, qkv bias, 8 prefix embeddings), DBRX, zamba2-7b at 5 layers
     (two super-blocks of Mamba2 layers and the shared attention block,
     and a tail) and xlstm-1.3b at 4 layers (no KV: no block, no kernel)
     served on the CPU (plain versions) and on the card (kernels):
     identical tokens; then reduced h2o-danube-3-4b trained two AdamW
     steps on the CPU and on the card from the same weights and batches
     (loss, grad_norm, moments and parameters at stated tolerances);
  5. the first path: full-width yi-6b (random weights from a seed) served
     through ``HarvestRuntime(...).server(...)`` with evictions, reloads and
     quantized demotions; every kernel of the path must have launched; then
     one full-width decode step profiled (wall time, device-busy share, the
     largest kernels);
  6. the second path: full-width qwen2-moe (15.15 B parameters) served the
     same way, through the MoE expert FFN kernel too, and profiled;
  7. the long-prompt path: full-width h2o-danube-3-4b (sliding window
     4,096, head dim 120) serving 4 requests of 4,500-6,000 prompt tokens
     over 16-token blocks, each preemption evicting hundreds of blocks to
     the peer and the host; then a decode step over that pool profiled,
     paged decode timed at that pool (its slots split over many blocks;
     cold, cycling through the layers' pools, and on one layer's pool),
     one eviction of the served engine profiled (the gather and the
     quantized round trip only: no id copied to the card, no copy of the
     payload on it), one reload (the payload's copy to the card and the
     copy kernel, no id copied), and one 6,000-token prefill profiled for
     prefill attention's share;
  8. Llama-4 (llama4-maverick-400b-a17b) at full width and 4 of its 48
     layers (two dense/MoE pairs, 35.04 B parameters; the whole model does
     not fit one card), 4 requests of 8,300-8,800 prompt tokens over
     the long path's geometry, prefill and decode crossing its 8,192-token
     attention chunk, through all seven kernels; then the expert FFN held
     and timed at its decode shape on the model's own 128 experts, a
     decode step profiled, paged decode at that pool, one 8,800-token
     prefill profiled;
  9. command-r-35b (parallel blocks, all 40 layers, 30.28 B parameters)
     and nemotron-4-15b (squared ReLU, GQA group 6, all 32 layers, 15.63 B)
     at full width on yi-6b's workload, each profiled;
 10. qwen2-vl-72b (M-RoPE, qkv bias, every prefill behind 1,024 prefix
     embeddings) at 36 of its 80 layers (34.09 B parameters) and dbrx-132b
     (16 experts top-4 of width 10,752, every layer) at 10 of its 40
     (33.82 B) on yi-6b's workload, each profiled; the expert FFN held and
     timed at DBRX's decode shape on the model's own 16 experts;
 11. zamba2-7b (81 Mamba2 layers and one shared attention block after
     every sixth: 13 KV layers, 6.75 B parameters) and xlstm-1.3b (48
     mLSTM and sLSTM blocks, no KV, 2.05 B) whole on yi-6b's workload,
     each decode step carrying the batch's recurrent states (their bytes
     printed); a decode step from zero states and a 40-token prefill
     profiled;
 12. the training path: full-width h2o-danube-3-4b (all 24 layers, 3.962
     B parameters) trained 5 AdamW steps of 1 x 8,192 tokens from the
     synthetic corpus, its footprint reckoned from ``abstract_params``
     before it is allocated, every block recomputed in the backward pass,
     attention's forward and backward through K4's kernels (48 forward
     and 24 backward launches a step, nothing else); each step's wall,
     tokens/s, loss and grad_norm, peak memory and the model-flops share
     of the bf16 peak printed, one step profiled (its trace must show the
     backward's wgmma kernels and no other backward kernel); then every
     kernel without a backward must raise when handed a tensor that
     requires grad;
then the card's name and power limit, one JSON line of per-kernel
numbers, and the JSON result line.  The launch counts are set to 0 just
before each path and read just after it.  It imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HarvestRuntime, paged_attention as tpa  # noqa: E402
from repro_torch.core.tiers import Fidelity, kv_block_bytes  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus, make_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.harvest_copy import ops as hops  # noqa: E402
from repro_torch.kernels.moe_ffn import ops as mops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serving import TenantSpec, Workload  # noqa: E402
from repro_torch.train.loop import cosine_lr  # noqa: E402
from repro_torch.train.optim import (  # noqa: E402
    adamw_init, train_step, tree_leaves)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
SEED = 0
LLAMA4 = "llama4-maverick-400b-a17b"
#: Llama-4's depth on the card: two (dense, MoE) pairs of its 48 layers
LLAMA4_LAYERS = 4
QWEN2_VL, DBRX = "qwen2-vl-72b", "dbrx-132b"
ZAMBA2, XLSTM = "zamba2-7b", "xlstm-1.3b"
#: the depths that fit one card: 36 of qwen2-vl-72b's 80 layers (63.5 GiB
#: of weights), 10 of dbrx-132b's 40 (63.0 GiB); every layer of each has
#: the same shape
QWEN2_VL_LAYERS, DBRX_LAYERS = 36, 10
#: the least size of a timing pool that calls cycle through: past the
#: card's 50 MB L2, so that each call finds its rows cold
POOL_BYTES = 64 * 2 ** 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """``name<ints>`` of a mangled kernel name: the identifier that ends in
    ``kernel`` and its template's integer arguments."""
    m = re.search(r"\d+([a-z_]+kernel)(I\w*?E)?E*v", mangled)
    if not m:
        return mangled
    args = m.group(2) or ""
    ints = re.findall(r"Li(\d+)E", args)
    return m.group(1) + (f"<{','.join(ints) or args[1:-1]}>" if args else "")


def ptxas_by_kernel(report: str):
    """{kernel: (registers line, stack and spills line)} from ``ptxas -v``."""
    out, fn, spills = {}, None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            fn = kernel_label(line.split()[-1])
        elif "spill" in line and fn:
            spills = line.strip()
        elif "Used" in line and fn:
            out[fn] = (line.split(":", 1)[1].strip(), spills)
            fn = None
    return out


def hmma_by_kernel(sass: str):
    """{kernel: tensor-core (HMMA/HGMMA) instructions in its SASS}."""
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split()[-1])
            out[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            out[fn] += 1
    return out


def events_ms(fn, iters) -> float:
    """Mean time per call of ``fn`` between CUDA events around ``iters``
    back-to-back calls: device time plus any gap the host leaves."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: idle host time inside a profiler window on each side of the calls.  The
#: profiler keeps only the device rows whose card timestamps fall inside
#: the window's host timestamps, and on the H100 machine the card's clock
#: was seen up to 4 ms off the host's (a kernel stamped before its own
#: launch): a window that holds a short call alone came back without a
#: device row in 13 of 600 traces, one padded so in none of 600
#: (tools/probe_trace_window.py)
TRACE_PAD_S = 0.025


def profiled(fn, iters):
    """The profiler (CUDA activity) after ``iters`` calls of ``fn``, the
    card idle for ``TRACE_PAD_S`` before and after them in its window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # one profiling cycle is all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
    return prof


def trace_rows(fn, iters):
    """[(name, device ms per call)] of every kernel, memset and copy that
    ``iters`` calls of ``fn`` put on the card, from the profiler's trace,
    largest first."""
    return device_rows(profiled(fn, iters), iters)


def whole_trace(fn, iters, want=None, warmup=1):
    """[(name, launches per call, device ms per call)] of ``iters`` calls of
    ``fn`` (after ``warmup`` calls) from a trace in which every row ran a
    whole number of times a call and ``want(rows)`` holds where given;
    taken again, up to three times, where a trace lost rows."""
    from torch.autograd import DeviceType
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        prof = profiled(fn, iters)
        rows = [(r.key, r.count / iters,
                 getattr(r, "self_device_time_total",
                         getattr(r, "self_cuda_time_total", 0.0))
                 / 1e3 / iters)
                for r in prof.key_averages()
                if r.device_type != DeviceType.CPU and r.count]
        if rows and all(c == int(c) for _, c, _ in rows) \
                and (want is None or want(rows)):
            return rows
    raise RuntimeError(f"three traces lost rows: {rows}")


def time_ms(fn, iters=50, warmup=5):
    """(device ms, events ms) per call of ``fn``.  Device ms is the sum of
    the durations of every kernel, memset and copy the call puts on the
    card, from the profiler's trace; where the trace shows no device time
    it falls back to the events time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    wall = events_ms(fn, iters)
    ms = sum(t for _, t in trace_rows(fn, iters))
    return (ms if ms > 0 else wall), wall


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_scenario(rng, b, n_slots, bs, nkv, nq, hd, q_pos, empty_row=None,
                   layers=1):
    """Pools whose slots are dealt to requests in shuffled order; the rest
    are free slots holding garbage."""
    dev = "cuda"
    q = torch.from_numpy(rng.normal(size=(b, nq, hd)).astype(np.float32))
    pk = torch.from_numpy(rng.normal(
        size=(layers, n_slots, bs, nkv, hd)).astype(np.float32))
    pv = torch.from_numpy(rng.normal(
        size=(layers, n_slots, bs, nkv, hd)).astype(np.float32))
    slot_req = np.full((n_slots,), -1, np.int32)
    slot_base = rng.integers(0, 512, size=n_slots).astype(np.int32)
    order = iter(rng.permutation(n_slots))
    for r in range(b):
        if r != empty_row:
            for j in range(q_pos[r] // bs + 1):
                slot = next(order)
                slot_req[slot], slot_base[slot] = r, j * bs
    t = dict(q=q, pk=pk, pv=pv, slot_req=torch.from_numpy(slot_req),
             slot_base=torch.from_numpy(slot_base),
             q_pos=torch.from_numpy(np.asarray(q_pos, np.int32)))
    return {k: v.to(dev) for k, v in t.items()}


def k1_bound(q_pos, n_slots, nq, nkv, hd, window=None, chunk=None):
    """The least time of one K1 call on these inputs: each position the
    masks keep (the window, and the attention chunk that holds the row)
    reads its k and v row of each kv head once, q is read, (m, l, acc)
    written; 4 flops per q row per position per hd column (score and
    weighted sum)."""
    def kept(p):
        lo = max(p - (window or 10 ** 9) + 1, 0)
        if chunk:
            lo = max(lo, p // chunk * chunk)
        return p - lo + 1

    positions = sum(kept(int(p)) for p in q_pos)
    b = len(q_pos)
    nbytes = 4 * (2 * positions * nkv * hd          # k and v rows
                  + b * nq * hd                     # q
                  + 2 * n_slots + b                 # slot_req/base, q_pos
                  + b * nq * (2 + hd))              # m, l, acc
    return bound(nbytes, 4 * positions * nq * hd)


def check_paged_decode(full_cfg, bs, more=(), chunked=()):
    """K1 at the full-width decode shape of ``full_cfg`` (yi-6b: gq 8, hd
    128) and of each config in ``more`` (nemotron-4-15b: gq 6, command-r-35b:
    64 / 8 heads, llama4-maverick-400b-a17b: gq 5, qwen2-vl-72b: 64 / 8
    heads), held to the plain
    version and timed; edge cases at ``full_cfg``'s heads: free slots, an
    empty request, sliding window, chunked-local; then at a card-filling
    pool of short contexts at ``full_cfg``'s heads, and at each config in
    ``chunked`` with its attention chunk and rows on both sides of a chunk
    boundary.  The kernels line keeps ``full_cfg``'s numbers,
    ``by_shape`` every shape's."""
    rng = np.random.default_rng(SEED)
    nq, nkv, hd = (full_cfg.num_heads, full_cfg.num_kv_heads,
                   full_cfg.resolved_head_dim)
    err = 0.0
    cases = [(full_cfg, 8, (61, 0, 17, 33)),
             (dataclasses.replace(full_cfg, sliding_window=20), 16,
              (61, 5, 17, 33)),
             (dataclasses.replace(full_cfg, attention_chunk=24), 8,
              (61, 5, 0, 33))]
    for cfg, cbs, q_pos in cases:
        s = paged_scenario(rng, 4, 40, cbs, nkv, nq, hd, q_pos, empty_row=1)
        args = (s["q"], s["pk"][0], s["pv"][0], s["slot_req"],
                s["slot_base"], s["q_pos"], cfg)
        got = tpa.pool_partials(*args)
        ref = pops.paged_decode_partials_plain(
            *args[:6], scale=hd ** -0.5, sliding_window=cfg.sliding_window,
            attention_chunk=cfg.attention_chunk)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            err = max(err, (a - b).abs().max().item())
        assert torch.all(got.l[1] == 0) and torch.all(got.m[1] == -1e30)

    rows = [dict(shape=cfg.name, **time_paged_decode(cfg, bs, rng))
            for cfg in (full_cfg, *more)]
    rows.append(time_card_pool_k1(full_cfg, bs))
    rows += [time_chunked_k1(cfg, 16, rng) for cfg in chunked]
    gc.collect()
    torch.cuda.empty_cache()
    main = rows[0]
    return dict(name="paged_decode_partials", route="cuda",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:75",
                max_abs_err=max(err, *(r["max_abs_err"] for r in rows)),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, shape=main["shape"], by_shape=rows)


def time_paged_decode(cfg, bs, rng):
    """K1 held to its plain version and timed at ``cfg``'s full-width
    decode shape as the main path gives it: 4 batch rows, a 10-slot pool
    of ``bs``-token blocks per layer, all 10 slots owned, cycling through 4
    pools per layer as a decode step cycles through its layers (80 MiB at
    yi-6b, more than the 50 MB L2, so each call finds its pool cold as in
    the step, where the weights stream between two layers' calls)."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    L = 4 * M.num_kv_layers(cfg)
    q_pos = (23, 15, 31, 7)
    s = paged_scenario(rng, 4, 10, bs, nkv, nq, hd, q_pos, layers=L)
    layer = [0]

    def call(fn):
        i = layer[0] = (layer[0] + 1) % L
        fn(s["q"], s["pk"][i], s["pv"][i], s["slot_req"], s["slot_base"],
           s["q_pos"], scale=hd ** -0.5)

    got = pops.paged_decode_partials(s["q"], s["pk"][0], s["pv"][0],
                                     s["slot_req"], s["slot_base"],
                                     s["q_pos"], scale=hd ** -0.5)
    ref = pops.paged_decode_partials_plain(s["q"], s["pk"][0], s["pv"][0],
                                           s["slot_req"], s["slot_base"],
                                           s["q_pos"], scale=hd ** -0.5)
    err = 0.0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        err = max(err, (a - b).abs().max().item())
    (ms, ms_wall) = time_ms(lambda: call(pops.paged_decode_partials), 320)
    plain_ms, _ = time_ms(lambda: call(pops.paged_decode_partials_plain), 64)
    bound_ms, bound_by = k1_bound(q_pos, 10, nq, nkv, hd)
    print(f"  paged_decode_partials at {cfg.name} ({nq}/{nkv} heads, gq "
          f"{nq // nkv}, hd {hd}): {ms:.5f} ms device, {ms_wall:.5f} ms per "
          f"call between events (host-bound at this size); plain "
          f"{plain_ms:.5f}; bound {bound_ms:.6f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, gq=nq // nkv)


def time_chunked_k1(cfg, bs, rng):
    """K1 at ``cfg``'s heads with its attention chunk (Llama-4: 8,192),
    four rows on both sides of the first chunk boundary (positions 8,191,
    8,192, 8,300 and 9,000 at 8,192), each request's slots dealt out of
    one pool of ``bs``-token blocks, so that the chunk mask cuts every
    slot of an earlier chunk; held to the plain version and timed.  The
    bound counts the positions the chunk keeps."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    c = cfg.attention_chunk
    q_pos = (c - 1, c, c + 108, c + 808)
    n_slots = sum(p // bs + 1 for p in q_pos) + 64
    s = paged_scenario(rng, 4, n_slots, bs, nkv, nq, hd, q_pos)
    args = (s["q"], s["pk"][0], s["pv"][0], s["slot_req"], s["slot_base"],
            s["q_pos"])
    kw = dict(scale=hd ** -0.5, attention_chunk=c)
    got = pops.paged_decode_partials(*args, **kw)
    ref = pops.paged_decode_partials_plain(*args, **kw)
    err = 0.0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        err = max(err, (a - b).abs().max().item())
    # the row at the boundary keeps its own position alone: one key, p = 1
    torch.testing.assert_close(got.l[1], torch.ones_like(got.l[1]))
    ms, ms_wall = time_ms(lambda: pops.paged_decode_partials(*args, **kw),
                          100)
    plain_ms, _ = time_ms(
        lambda: pops.paged_decode_partials_plain(*args, **kw), 10)
    bound_ms, bound_by = k1_bound(q_pos, n_slots, nq, nkv, hd, chunk=c)
    print(f"  paged_decode_partials at {cfg.name} ({nq}/{nkv} heads, gq "
          f"{nq // nkv}, hd {hd}) with attention chunk {c}, rows at "
          f"{list(q_pos)} over {n_slots} slots of {bs}: {ms:.5f} ms device, "
          f"{ms_wall:.5f} between events; plain {plain_ms:.5f}; bound "
          f"{bound_ms:.6f} ({bound_by})")
    return dict(shape=f"{cfg.name} chunk {c}, rows {list(q_pos)}", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, gq=nq // nkv, n_slots=n_slots)


#: GiB of the card that a card-filling pool gives to the KV pools
CARD_POOL_GIB = 64


def card_pool_scenario(cfg, bs, b=64, pos=(100, 1000)):
    """Short contexts in a card-filling pool: one layer's slots when
    ``CARD_POOL_GIB`` GiB of the card hold ``cfg``'s f32 pools of every
    layer (65,536 slots of 8 at yi-6b), ``b`` requests at positions drawn
    from ``pos`` owning slots scattered over it, the rest free.  Pools and
    q made on the card from a seed.  Returns K1's operands."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n_slots = CARD_POOL_GIB * 2 ** 30 // (cfg.num_layers * 2 * bs * nkv
                                          * hd * 4)
    rng = np.random.default_rng(SEED + 9)
    q_pos = rng.integers(*pos, size=b).astype(np.int32)
    per_req = q_pos // bs + 1
    slot_req = np.full((n_slots,), -1, np.int32)
    slot_base = rng.integers(0, 1024, size=n_slots).astype(np.int32)
    slots = rng.permutation(n_slots)[:per_req.sum()]
    slot_req[slots] = np.repeat(np.arange(b, dtype=np.int32), per_req)
    slot_base[slots] = np.concatenate([np.arange(c, dtype=np.int32) * bs
                                       for c in per_req])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    q = torch.randn((b, nq, hd), generator=gen, device="cuda")
    pk = torch.randn((n_slots, bs, nkv, hd), generator=gen, device="cuda")
    pv = torch.randn((n_slots, bs, nkv, hd), generator=gen, device="cuda")
    return (q, pk, pv) + tuple(torch.from_numpy(a).cuda()
                               for a in (slot_req, slot_base, q_pos))


def time_card_pool_k1(cfg, bs):
    """K1 held to its plain version and timed at ``card_pool_scenario``,
    where scanning the slot table, not reading the live rows, would show
    if a design scanned it once per block."""
    args = card_pool_scenario(cfg, bs)
    q, slot_req, q_pos = args[0], args[3], args[5]
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, n_slots = q.shape[0], slot_req.shape[0]
    kw = dict(scale=hd ** -0.5)
    got = pops.paged_decode_partials(*args, **kw)
    ref = pops.paged_decode_partials_plain(*args, **kw)
    err = 0.0
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
        err = max(err, (a - r).abs().max().item())
    del got, ref
    ms, ms_wall = time_ms(lambda: pops.paged_decode_partials(*args, **kw), 50)
    plain_ms, _ = time_ms(
        lambda: pops.paged_decode_partials_plain(*args, **kw), 10)
    bound_ms, bound_by = k1_bound(q_pos.tolist(), n_slots, nq, nkv, hd)
    owned = int((slot_req >= 0).sum())
    splits = pops.num_splits(b, nkv, n_slots, pops.sm_count(q.device))
    print(f"  paged_decode_partials at a card-filling {cfg.name} pool "
          f"({n_slots} slots of {bs}, {owned} owned by {b} requests at "
          f"positions {int(q_pos.min())}-{int(q_pos.max())}, {splits} "
          f"splits): {ms:.5f} ms device, {ms_wall:.5f} between events; "
          f"plain {plain_ms:.5f}; bound {bound_ms:.6f} ({bound_by})")
    return dict(shape=f"{cfg.name} card-filling pool", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, gq=nq // nkv, n_slots=n_slots,
                owned=owned, splits=splits)


def block_elems(cfg, bs) -> int:
    """f32 elements of one demoted block: a row of L_kv * 2 * bs * nkv * hd,
    as the engine's _degrade passes it."""
    return (M.num_kv_layers(cfg) * 2 * bs * cfg.num_kv_heads
            * cfg.resolved_head_dim)


#: runtime calls the profiler may hang the next kernel's time on: no row of
#: a trace may carry their names
RUNTIME_CALLS = ("cudaFuncSetAttribute", "cudaLaunchKernelEx")


def traced_rows(fn, iters):
    """``trace_rows`` of ``iters`` calls of ``fn``, taken again (up to three
    times) where a trace came back without a device row; asserts that no
    row is named after a runtime call."""
    for _ in range(3):
        rows = [(n, t) for n, t in trace_rows(fn, iters) if t > 0]
        if rows:
            assert not any(c in n for n, _ in rows for c in RUNTIME_CALLS), \
                rows
            return rows
        print("  a trace came back without a device row: taken again",
              file=sys.stderr)
    raise RuntimeError("three traces showed no device row")


def check_quant(paths):
    """K2 and K3 against their plain versions: every fidelity; three rows
    (one all zero) at an odd width, at each (cfg, bs) path's full-width
    demoted block and at a 4 MiB row; slices longer than K2 keeps in
    shared memory, a whole odd row per block (200 rows of 60,001) and a
    row spread over the card (3 rows of 3,000,000); 300 rows, whose ids
    K3 reads from a device table; the odd width and the paths' blocks
    again on bf16 and f16 pools; out-of-range ids raising; values, scales
    and pools bit for bit.  Then both timed at each path's block as
    _degrade calls them (one row; device ids with their host mirror), a
    trace of one K2 call showing its one kernel and nothing else, K3 split
    into its kernel's own device time and any copy of its ids to the card
    (none).  The kernels line keeps the first path's numbers and every
    path's under ``by_shape``."""
    rng = np.random.default_rng(SEED + 1)
    err = {"quantize_demote": 0.0, "dequantize_reload": 0.0}
    widths = (37, *(block_elems(c, b) for c, b in paths))
    cases = [(3, w, torch.float32) for w in (*widths, 1_048_576)] \
        + [(200, 60_001, torch.float32), (3, 3_000_000, torch.float32),
           (300, 1_024, torch.float32)] \
        + [(3, w, dt) for dt in (torch.bfloat16, torch.float16)
           for w in widths]
    for m, width, dtype in cases:
        src = (rng.normal(size=(m + 3, width))
               * rng.uniform(0.01, 30, size=(m + 3, 1))).astype(np.float32)
        src[3] = 0.0
        ids = rng.permutation(m + 3)[:m].astype(np.int32)
        ids[0] = 3
        src_t = torch.from_numpy(src).to(dtype).cuda()
        dst = torch.from_numpy(rng.normal(size=(m + 4, width)).astype(
            np.float32)).to(dtype).cuda()
        dids = rng.permutation(m + 4)[:m].astype(np.int32)
        for fid in ("int8", "fp8", "int4"):
            pv, ps = hops.quantize_blocks_plain(src_t, ids, fid)
            gv, gs = hops.quantize_blocks(src_t, ids, fidelity=fid)
            assert torch.equal(gv.view(torch.uint8), pv.view(torch.uint8)), \
                (fid, m, width, dtype)
            assert torch.equal(gs, ps), (fid, m, width, dtype)
            err["quantize_demote"] = max(
                err["quantize_demote"],
                (gv.float() - pv.float()).abs().max().item(),
                (gs - ps).abs().max().item())
            ref = hops.dequantize_blocks_plain(dst.clone(), pv, ps, dids, fid)
            got = hops.dequantize_blocks(dst.clone(), gv, gs, dids,
                                         fidelity=fid)
            assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), \
                (fid, m, width, dtype)
            err["dequantize_reload"] = max(err["dequantize_reload"],
                                           _max_err(got, ref))
        del src_t, dst
    src = torch.zeros((4, 16), device="cuda")
    for call in (lambda: hops.quantize_blocks(src, np.asarray([0, 4])),
                 lambda: hops.dequantize_blocks(
                     src, torch.zeros((1, 16), dtype=torch.int8,
                                      device="cuda"),
                     torch.ones((1, 1), device="cuda"), np.asarray([-1]))):
        try:
            call()
        except IndexError:
            pass
        else:
            raise AssertionError("out-of-range slot ids were not refused")
    torch.cuda.synchronize()

    # timing: the main path demotes one block per eviction at int8 (the
    # slo policy's quantized classes), a (1, elems) row on the device, its
    # id on the device with a host mirror; rows cycle through a pool of 64
    # rows or more, 64 MiB and more, so the source is not L2-resident
    by_shape = {"quantize_demote": {}, "dequantize_reload": {}}
    for cfg, bs in paths:
        elems = block_elems(cfg, bs)
        n_rows = max(64, -(-POOL_BYTES // (4 * elems)))
        pool = torch.from_numpy(rng.normal(size=(n_rows, elems)).astype(
            np.float32)).cuda()
        row_ids = [torch.tensor([i], dtype=torch.int32, device="cuda")
                   for i in range(n_rows)]
        mirrors = [np.asarray([i], np.int32) for i in range(n_rows)]
        nxt = [0]

        def ids():
            nxt[0] = (nxt[0] + 1) % n_rows
            return row_ids[nxt[0]], mirrors[nxt[0]]

        def quant():
            dev_ids, host = ids()
            return hops.quantize_blocks(pool, dev_ids, fidelity="int8",
                                        host_ids=host)

        def dequant():
            dev_ids, host = ids()
            return hops.dequantize_blocks(dst, vals, scales, dev_ids,
                                          fidelity="int8", host_ids=host)

        vals, scales = quant()
        dst = torch.zeros_like(pool)
        rows = traced_rows(quant, 1)
        assert len(rows) == 1 and "quantize_rows_kernel" in rows[0][0], rows
        print(f"  quantize_demote at {cfg.name}: one call's trace "
              f"{[(n[:50], round(t, 6)) for n, t in rows]}")
        # K3 as _degrade calls it: its kernel's own rows and any
        # host-to-device copy of its ids (none: they ride in the launch)
        for _ in range(5):
            dequant()
        rows = traced_rows(dequant, 200)
        k3_own = sum(t for n, t in rows if "dequantize_kernel" in n)
        k3_h2d = sum(t for n, t in rows if "HtoD" in n)
        assert k3_own > 0 and k3_h2d == 0 and len(rows) == 1, rows
        print(f"  dequantize_reload at {cfg.name}: kernel {k3_own:.5f} ms "
              f"device + ids host-to-device {k3_h2d:.5f} = "
              f"{sum(t for _, t in rows):.5f} per call as _degrade makes it")
        for fn_k, fn_p, nbytes, name in (
            (quant, lambda: hops.quantize_blocks_plain(pool, ids()[0],
                                                       "int8"),
             4 * elems + elems + 4, "quantize_demote"),
            (dequant, lambda: hops.dequantize_blocks_plain(dst, vals, scales,
                                                  ids()[0], "int8"),
             elems + 4 + 4 * elems, "dequantize_reload"),
        ):
            (ms, ms_wall), (plain_ms, _) = time_ms(fn_k, 200), \
                time_ms(fn_p, 50)
            bound_ms, bound_by = bound(nbytes, 3 * elems)
            print(f"  {name} at {cfg.name} ({elems} f32): {ms:.5f} ms "
                  f"device ({ms_wall:.5f} between events), plain "
                  f"{plain_ms:.5f}, bound {bound_ms:.6f} ({bound_by})")
            by_shape[name][cfg.name] = dict(
                elems=elems, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
        by_shape["dequantize_reload"][cfg.name].update(
            kernel_ms=k3_own, ids_h2d_ms=k3_h2d)
        del pool, dst
    out = []
    for name, line in (("quantize_demote", 199), ("dequantize_reload", 246)):
        first = by_shape[name][paths[0][0].name]
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/harvest_quant.cu",
            replaces=f"src/repro/kernels/harvest_copy/kernel.py:{line}",
            max_abs_err=err[name], ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
            shape=paths[0][0].name,
            by_shape=by_shape[name]))
    return out


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def check_movers(configs):
    """K6 and K5 against their plain versions, bit for bit: f32, bf16 and
    int8 rows, an odd width (the narrow vector path) and a layer row's
    width, a repeated gather id, rows outside the copy kept, a pool copied
    into itself, out-of-range ids refused.  Then at each model's per-pool
    shape, the one the engine's evict (K6) and reload (K5, from a staging
    pool of k and v rows) give them: one launch moves one slot's block of
    every layer (L_kv rows of bs * nkv * hd f32), for each (cfg, bs) of
    ``configs``.  There both are held to their plain versions bit for bit
    on the first, second and last slot of the timing loop, and then timed
    like for like: each wrapper as the engine calls it, with host ids
    (they ride in both kernels' launches), K6 into one half of an (L, 2,
    ...) payload, K5 from a staging pool of k and v rows, split into the
    kernel's own device time and any host-to-device copy of its ids (there
    must be none); the library calls with device ids and again with host
    ids.  Past the rows whose ids ride in the launch (300 rows), both read
    them from a device table, bit for bit.  The kernels
    line keeps the last shape's numbers, ``ms`` the kernel's own and
    ``library_ms`` the library's with device ids, and every shape's under
    ``by_shape``."""
    rng = np.random.default_rng(SEED + 3)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for width in (37, 16_384):
            src = torch.from_numpy(rng.normal(size=(12, width)) * 40).to(
                dtype).cuda()
            dst = torch.from_numpy(rng.normal(size=(9, width)) * 40).to(
                dtype).cuda()
            ids = np.asarray([11, 0, 4, 11], np.int32)
            assert torch.equal(hops.gather_blocks(src, ids),
                               hops.gather_blocks_plain(src, ids))
            sids, dids = [3, 10, 0], [8, 2, 5]
            assert torch.equal(
                hops.copy_blocks(src, dst.clone(), sids, dids),
                hops.copy_blocks_plain(src, dst.clone(), sids, dids))
            pool = src.clone()
            hops.copy_blocks(pool, pool, [0, 1], [5, 6])
            assert torch.equal(pool, hops.copy_blocks_plain(
                src, src.clone(), [0, 1], [5, 6]))
    # past the rows whose ids ride in the launch, K6 and K5 read them from
    # the card
    src = torch.from_numpy(rng.normal(size=(50, 96)).astype(np.float32))
    ids = rng.integers(0, 50, size=300).astype(np.int32)
    assert torch.equal(hops.gather_blocks(src.cuda(), torch.from_numpy(
        ids).cuda(), host_ids=ids).cpu(), hops.gather_blocks_plain(src, ids))
    src = torch.from_numpy(rng.normal(size=(700, 96)).astype(np.float32))
    perm = rng.permutation(700).astype(np.int32)
    sids, dids = perm[:300], perm[300:600]
    ref = hops.copy_blocks_plain(src, src.clone(), sids, dids)
    pool = src.cuda()         # one pool, disjoint rows
    assert torch.equal(hops.copy_blocks(pool, pool, sids, dids).cpu(), ref)
    assert torch.equal(hops.copy_blocks(src.cuda(), src.cuda(), sids,
                                        dids).cpu(), ref)
    pool = torch.zeros((4, 16), device="cuda")
    for call in (lambda: hops.gather_blocks(pool, np.asarray([0, 4])),
                 lambda: hops.copy_blocks(pool, pool.clone(), [0], [-1])):
        try:
            call()
        except IndexError:
            pass
        else:
            raise AssertionError("out-of-range slot ids were not refused")
    torch.cuda.synchronize()

    out, err = {}, {"gather_blocks": 0.0, "copy_blocks": 0.0}
    by_shape = {"gather_blocks": {}, "copy_blocks": {}}
    for cfg, bs in configs:
        L = M.num_kv_layers(cfg)
        elems = bs * cfg.num_kv_heads * cfg.resolved_head_dim
        # 128 slots or more: the pool (64 MiB at yi-6b and at the 4-layer
        # Llama-4, 180 MiB at h2o-danube-3-4b, 192 MiB at qwen2-moe)
        # exceeds the 50 MB L2, and each call takes the next slot
        n_slots = max(128, -(-POOL_BYTES // (4 * L * elems)))
        pool = torch.from_numpy(rng.normal(size=(L * n_slots, elems)).astype(
            np.float32)).cuda()
        staging = torch.from_numpy(rng.normal(size=(2 * L, elems)).astype(
            np.float32)).cuda()
        # the eviction's payload: K6 gathers k into one half of it
        half = torch.empty((L, 2, elems), device="cuda")[:, 0]
        layer_rows = np.arange(L, dtype=np.int32) * n_slots
        k_rows = 2 * np.arange(L, dtype=np.int32)
        # the library calls' ids on the device (int32 as the kernels take
        # them; index_copy_ takes int64 only)
        dev_ids = [torch.from_numpy(layer_rows + i).cuda()
                   for i in range(n_slots)]
        dev_ids64 = [t.long() for t in dev_ids]
        dev_k_rows = torch.from_numpy(k_rows).cuda()
        nxt = [0]

        def slot():
            nxt[0] = (nxt[0] + 1) % n_slots
            return nxt[0]

        def host(ids, dtype=torch.int32):
            # ids from the host, copied to the card for the library call
            return torch.as_tensor(ids).to(device="cuda", dtype=dtype)

        row_bytes = 4 * elems
        # (name, Pallas line, its kernel's name, kernel, plain version,
        # library call, it with device ids, it with host ids, bytes): the
        # kernels and the plain versions take host ids, as the engine's
        # evict and reload pass them
        cases = (
            ("gather_blocks", 68, "gather_rows_kernel",
             lambda: hops.gather_blocks(pool, layer_rows + slot(), out=half),
             lambda: hops.gather_blocks_plain(pool, layer_rows + slot()),
             "index_select",
             lambda: torch.index_select(pool, 0, dev_ids[slot()]),
             lambda: torch.index_select(pool, 0, host(layer_rows + slot())),
             2 * L * row_bytes + 4 * L),
            ("copy_blocks", 96, "copy_rows_kernel",
             lambda: hops.copy_blocks(staging, pool, k_rows,
                                      layer_rows + slot()),
             lambda: hops.copy_blocks_plain(staging, pool, k_rows,
                                            layer_rows + slot()),
             "index_select + index_copy_",
             lambda: pool.index_copy_(0, dev_ids64[slot()], torch.index_select(
                 staging, 0, dev_k_rows)),
             lambda: pool.index_copy_(
                 0, host(layer_rows + slot(), torch.long),
                 torch.index_select(staging, 0, host(k_rows))),
             2 * L * row_bytes + 8 * L),
        )
        for s in (0, 1, n_slots - 1):
            got = hops.gather_blocks(pool, layer_rows + s, out=half)
            ref = hops.gather_blocks_plain(pool, layer_rows + s)
            assert torch.equal(got, ref), f"gather_blocks at {cfg.name}"
            err["gather_blocks"] = max(err["gather_blocks"],
                                       _max_err(got, ref))
            got = hops.copy_blocks(staging, pool.clone(), k_rows,
                                   layer_rows + s)
            ref = hops.copy_blocks_plain(staging, pool.clone(), k_rows,
                                         layer_rows + s)
            assert torch.equal(got, ref), f"copy_blocks at {cfg.name}"
            err["copy_blocks"] = max(err["copy_blocks"], _max_err(got, ref))
            del got, ref
        torch.cuda.synchronize()
        for name, line, kname, fn_k, fn_p, lib, fn_dev, fn_host, nbytes \
                in cases:
            # the wrapper as the engine calls it: its kernel's own rows of
            # the trace, and any host-to-device copy of its ids
            ms_wall = time_ms(fn_k, 200)[1]
            rows = traced_rows(fn_k, 200)
            call_ms = sum(t for _, t in rows)
            own = sum(t for n, t in rows if kname in n)
            h2d = sum(t for n, t in rows if "HtoD" in n)
            rest = [n for n, t in rows if kname not in n and "HtoD" not in n]
            assert own > 0 and not rest and h2d == 0, rows
            plain_ms, _ = time_ms(fn_p, 100)
            library_ms, _ = time_ms(fn_dev, 200)
            library_host_ms, _ = time_ms(fn_host, 200)
            bound_ms, bound_by = bound(nbytes, 0)
            print(f"  {name} at {cfg.name} ({L} rows of {row_bytes} B): "
                  f"kernel {own:.5f} ms device + ids host-to-device "
                  f"{h2d:.5f} = {call_ms:.5f} per call as the engine makes "
                  f"it ({ms_wall:.5f} between events); {lib} with device "
                  f"ids {library_ms:.5f}, with ids from the host "
                  f"{library_host_ms:.5f}; plain {plain_ms:.5f}; bound "
                  f"{bound_ms:.6f}")
            out[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/harvest_copy.cu",
                replaces=f"src/repro/kernels/harvest_copy/kernel.py:{line}",
                max_abs_err=err[name], ms=own, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library=f"{lib}, ids on the device",
                ids_h2d_ms=h2d, call_ms=call_ms,
                library_host_ids_ms=library_host_ms, shape=cfg.name,
                by_shape=by_shape[name])
            by_shape[name][cfg.name] = dict(
                ms=own, ids_h2d_ms=h2d, plain_ms=plain_ms,
                library_ms=library_ms, library_host_ids_ms=library_host_ms,
                bound_ms=bound_ms)
        del pool, staging, half
    return [out["gather_blocks"], out["copy_blocks"]]


#: K7 against its plain version.  bf16: the kernel and cuBLAS sum each
#: product in another order, so where a sum lies at a rounding boundary an
#: intermediate (h, g, act(g) * h) rounds one bf16 step apart, and the
#: outputs that read it move by |wo| times that step: one bf16 step at
#: magnitude 1.  f32: sums of d and f terms in another order.
MOE_TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=2.0 ** -7),
           torch.float32: dict(rtol=1e-4, atol=1e-4)}


def dispatch_buffer(cfg, t, gen):
    """An (E, C, d) bf16 dispatch buffer as the MoE layer builds it from
    t rows routed by a random router; returns (xd, slot_token, t)."""
    mc = cfg.moe
    d = cfg.d_model
    x = torch.randn((t, d), generator=gen, device="cuda").bfloat16()
    router = torch.randn((d, mc.num_experts), generator=gen,
                         device="cuda") * 0.02
    weights, ids, _ = MOE.router_topk(x.float() @ router, mc.top_k)
    cap = max(int(t * mc.top_k / mc.num_experts * mc.capacity_factor), 4)
    st, _ = MOE.build_dispatch(ids, weights, mc.num_experts, cap)
    xpad = torch.cat([x, x.new_zeros((1, d))])
    return xpad[st.long()].view(mc.num_experts, cap, d), st, t


def expert_weights(e, d, f, dtype, gen):
    return [(torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
            for shape in ((e, d, f), (e, d, f), (e, f, d))]


def check_moe_ffn(cfg, odd_cfg):
    """K7 against its plain version at qwen2-moe's decode shape (4 rows,
    capacity 4) and a prefill shape (128 rows, capacity 10), in bf16 and
    on the same values widened to f32, and at phi-tiny-moe's expert width
    (f = 915) in bf16 and f32; the experts the kernel skipped (no token:
    no weight read, exact zeros) counted on the card against the experts
    the dispatch leaves empty; then timed at both shapes.  The bound
    counts the weights of the experts that this dispatch gives a token,
    and the operations of the filled rows."""
    mc = cfg.moe
    e, d, f = mc.num_experts, cfg.d_model, mc.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    w = expert_weights(e, d, f, torch.bfloat16, gen)
    err = 0.0
    shapes = {}
    for t in (4, 128):
        xd, st, _ = dispatch_buffer(cfg, t, gen)
        empty = (st == t).view(e, -1)
        held = int((~empty).any(1).sum())
        for dtype in (torch.bfloat16, torch.float32):
            args = [a.to(dtype) for a in [xd] + w]
            skipped = torch.zeros((1,), dtype=torch.int32, device="cuda")
            got = mops.moe_ffn(*args, activation=cfg.activation,
                               skipped=skipped)
            ref = mops.moe_ffn_plain(*args, activation=cfg.activation)
            torch.testing.assert_close(got.float(), ref.float(),
                                       **MOE_TOL[dtype])
            assert torch.all(got[empty] == 0), "empty slots must give zeros"
            # one 16-row tile per expert at these capacities
            assert int(skipped.item()) == e - held, (skipped, held)
            err = max(err, (got.float() - ref.float()).abs().max().item())
            if dtype == torch.bfloat16:
                counted = int(skipped.item())
            del args
        print(f"  moe_ffn at {t} rows: C {xd.shape[1]}, {held} of {e} "
              f"experts hold a token; the kernel skipped {counted} "
              f"experts (read none of their weights; its counter)")
        shapes[t] = (xd, st, held, counted)
    oe, od, of = odd_cfg.moe.num_experts, odd_cfg.d_model, \
        odd_cfg.moe.d_ff_expert
    for dtype in (torch.bfloat16, torch.float32):
        ow = expert_weights(oe, od, of, dtype, gen)
        xd = torch.randn((oe, 6, od), generator=gen, device="cuda").to(dtype)
        xd[:, 4:] = 0
        got = mops.moe_ffn(xd, *ow, activation=odd_cfg.activation)
        ref = mops.moe_ffn_plain(xd, *ow, activation=odd_cfg.activation)
        torch.testing.assert_close(got.float(), ref.float(), **MOE_TOL[dtype])
        assert torch.all(got[:, 4:] == 0)
        err = max(err, (got.float() - ref.float()).abs().max().item())
    torch.cuda.synchronize()

    silu = torch.nn.functional.silu
    rows_out = []
    for t, (xd, st, used, counted) in shapes.items():
        (ms, ms_wall) = time_ms(lambda: mops.moe_ffn(xd, *w), 50)
        plain_ms, _ = time_ms(lambda: mops.moe_ffn_plain(xd, *w), 50)
        library_ms, _ = time_ms(lambda: torch.bmm(
            silu(torch.bmm(xd, w[1])) * torch.bmm(xd, w[0]), w[2]), 50)
        rows = int((st < t).sum())
        w_bytes = 3 * d * f * 2
        nbytes = used * w_bytes + 2 * xd.numel() * 2
        bound_ms, bound_by = bound(nbytes, rows * 2 * 3 * d * f, BF16_FLOPS)
        all_ms = (e * w_bytes + 2 * xd.numel() * 2) / HBM_BYTES_PER_S * 1e3
        print(f"  moe_ffn {'decode' if t == 4 else 'prefill'} shape ({t} "
              f"rows: E {e}, C {xd.shape[1]}, d {d}, f {f}): {ms:.5f} ms "
              f"device, {ms_wall:.5f} ms between events; plain "
              f"{plain_ms:.5f}; library (composition: bmm, silu, bmm, bmm) "
              f"{library_ms:.5f}; bound {bound_ms:.6f} ({used} experts, "
              f"{rows} rows); all-experts read {all_ms:.5f} ms (computed)")
        rows_out.append(dict(shape=f"{t} rows, C {xd.shape[1]}", ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             experts_with_token=used,
                             experts_skipped=counted))
    main = rows_out[0]
    return dict(name="moe_ffn", route="cuda",
                source="src/repro_torch/csrc/moe_ffn.cu",
                replaces="src/repro/kernels/moe_ffn/kernel.py:53",
                max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"],
                by_shape=rows_out)


def check_moe_ffn_experts(cfg, params, rows=None):
    """K7 at a decode shape on the served model's own experts (the first
    MoE layer's: Llama-4's 128 experts of d 5120 and f 8192, 32.2 GB in
    bf16, or DBRX's 16 of d 6144 and f 10752, 6.3 GB, which no second copy
    beside the model would leave room for).  ``rows``: a decode step's
    batch rows, routed by a random router into the (E, C, d) dispatch
    buffer as the MoE layer fills it (DBRX: 4 rows at top-4, C 4); None:
    Llama-4's buffer of C 4 in which 4 experts hold a token.  Held to the
    plain version in bf16; the experts without a token are skipped
    (counted on the card: one 16-row tile each) and give exact zeros.
    Then timed beside the plain version and the bmm composition; the bound
    counts the weights of the experts that hold a token and the operations
    of the rows that hold one."""
    mc = cfg.moe
    e, d, f = mc.num_experts, cfg.d_model, mc.d_ff_expert
    layer = params["blocks"]["moe"] if "blocks" in params else params["layers"]
    w = [layer["moe"][k][0] for k in ("wi", "wg", "wo")]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    if rows is None:
        cap = max(int(2 * mc.top_k / e * mc.capacity_factor), 4)
        xd = torch.zeros((e, cap, d), dtype=torch.bfloat16, device="cuda")
        held = torch.randperm(e, generator=gen, device="cuda")[:4]
        xd[held, 0] = torch.randn((len(held), d), generator=gen,
                                  device="cuda").bfloat16()
    else:
        xd = dispatch_buffer(cfg, rows, gen)[0]
        cap = xd.shape[1]
    empty = (xd == 0).all(-1)
    filled = int((~empty).any(1).sum())
    tokens = int((~empty).sum())
    skipped = torch.zeros((1,), dtype=torch.int32, device="cuda")
    got = mops.moe_ffn(xd, *w, activation=cfg.activation, skipped=skipped)
    ref = mops.moe_ffn_plain(xd, *w, activation=cfg.activation)
    torch.testing.assert_close(got.float(), ref.float(),
                               **MOE_TOL[torch.bfloat16])
    assert torch.all(got[empty] == 0), "empty slots must give zeros"
    assert int(skipped.item()) == e - filled, (skipped, filled)
    err = (got.float() - ref.float()).abs().max().item()
    del got, ref
    silu = torch.nn.functional.silu
    ms, ms_wall = time_ms(lambda: mops.moe_ffn(xd, *w), 50)
    plain_ms, _ = time_ms(lambda: mops.moe_ffn_plain(xd, *w), 10)
    library_ms, _ = time_ms(lambda: torch.bmm(
        silu(torch.bmm(xd, w[1])) * torch.bmm(xd, w[0]), w[2]), 10)
    w_bytes = 3 * d * f * 2
    bound_ms, bound_by = bound(filled * w_bytes + 2 * xd.numel() * 2,
                               tokens * 2 * 3 * d * f, BF16_FLOPS)
    print(f"  moe_ffn at {cfg.name}'s decode shape (E {e}, C {cap}, d {d}, "
          f"f {f}; {tokens} dispatched rows, {filled} experts hold a token, "
          f"the kernel skipped {e - filled}): {ms:.5f} ms device, "
          f"{ms_wall:.5f} between events; plain {plain_ms:.5f}; library "
          f"(bmm, silu, bmm, bmm) {library_ms:.5f}; bound {bound_ms:.6f} "
          f"({bound_by}); all experts' weights {e * w_bytes / 1e9:.1f} GB; "
          f"max_abs_err {err:.3g}")
    return dict(shape=f"{cfg.name} decode, E {e}, C {cap}, d {d}, f {f}",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                experts_with_token=filled, experts_skipped=e - filled,
                max_abs_err=err)


#: K4 against its plain version.  bf16: the plain version rounds each
#: probability to bf16 against the running max of its 1024-key chunk, the
#: kernel against that of its 64-key tile, so p differs by about one bf16
#: step and the rounded outputs by up to one step more: two bf16 steps at
#: magnitude 1.  f32: sums over hd and over keys in another order.
FLASH_TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=2.0 ** -7),
             torch.float32: dict(rtol=1e-4, atol=1e-4)}


#: K4's kernel for each dtype: (the name it has in the trace, the route)
ROUTES = {torch.bfloat16: ("flash_prefill_mma_kernel", "mma bf16"),
          torch.float32: ("flash_prefill_kernel", "fma f32")}


def top_kernel(fn) -> str:
    """The name of the kernel that takes the most device time in a few
    calls of ``fn``: which backend a library call took."""
    fn()
    torch.cuda.synchronize()
    return traced_rows(fn, 5)[0][0]


def check_flash_prefill(yi, moe, danube, more=()):
    """K4 against its plain version at the shapes the paths' prefills give
    it (``more``: (label, cfg, tokens, masks) of the later paths) and at
    an attention-chunk and a softcap case, in bf16 and f32, then each
    timed with the plain version and
    ``scaled_dot_product_attention`` (causal, or a band mask; none takes a
    softcap) beside it.  The bound counts the (q, k) pairs the mask keeps
    in this data: 4 * hd flops each, over the bf16 tensor-core rate or the
    f32 rate, against q, k, v and o moved once."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, err = [], 0.0
    # the three paths' prefills, and two small cases for the masks they lack
    shapes = [("yi-6b smoke prompt", yi, 40, {}),
              ("yi-6b padded tail", yi, 1032, {}),
              ("qwen2-moe smoke prompt", moe, 40, {}),
              ("h2o-danube-3-4b long prompt", danube, 6000,
               dict(sliding_window=danube.sliding_window)),
              ("attention chunk 128", yi, 300, dict(attention_chunk=128)),
              ("logit softcap 30", yi, 300, dict(logit_softcap=30.0)),
              *more]
    for label, cfg, n, masks in shapes:
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        pos = torch.arange(n, dtype=torch.int32, device="cuda")[None]
        base = [torch.randn((1, n, h, hd), generator=gen, device="cuda")
                for h in (nq, nkv, nkv)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            got = fops.prefill_attention(q, k, v, pos, pos, **masks)
            ref = fops.prefill_attention_plain(q, k, v, pos, pos, **masks)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref.float(),
                                       **FLASH_TOL[dtype])
            e = _max_err(got, ref)
            err = max(err, e)
            del got, ref
            # which kernel ran, from the trace: bf16 on the tensor cores,
            # f32 on the CUDA cores
            ran = top_kernel(lambda: fops.prefill_attention(
                q, k, v, pos, pos, **masks))
            route = ROUTES[dtype]
            assert route[0] in ran, (dtype, ran)
            iters = 5 if n > 2000 else 20
            (ms, ms_wall) = time_ms(lambda: fops.prefill_attention(
                q, k, v, pos, pos, **masks), iters)
            plain_ms, _ = time_ms(lambda: fops.prefill_attention_plain(
                q, k, v, pos, pos, **masks), iters)
            library_ms, backend = None, "none (no softcap in the library)"
            if not masks.get("logit_softcap"):
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                if masks:
                    band = fops.band_mask(pos[0], pos[0], **masks)
                    lib = lambda: sdpa(qt, kt, vt, attn_mask=band,  # noqa
                                       enable_gqa=True)
                else:
                    lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa
                                       enable_gqa=True)
                library_ms, _ = time_ms(lib, iters)
                backend = top_kernel(lib)
                del qt, kt, vt
            pairs = int(fops.band_mask(
                pos, pos, masks.get("sliding_window"),
                masks.get("attention_chunk")).sum())
            nbytes = q.element_size() * n * hd * (2 * nq + 2 * nkv) + 8 * n
            bound_ms, bound_by = bound(
                nbytes, 4 * hd * nq * pairs,
                BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
            print(f"  prefill_attention {label} ({n} tokens, {nq}/{nkv} "
                  f"heads, hd {hd}, {str(dtype)[6:]}, {route[1]}): "
                  f"{ms:.5f} ms device, "
                  f"{ms_wall:.5f} between events; plain {plain_ms:.5f}; "
                  f"library {library_ms} [{backend[:60]}]; bound "
                  f"{bound_ms:.5f} ({bound_by}, {pairs} pairs per head); "
                  f"max_abs_err {e:.3g}")
            rows.append(dict(shape=label, tokens=n, dtype=str(dtype)[6:],
                             route=route[1], ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, library_backend=backend,
                             bound_ms=bound_ms,
                             bound_by=bound_by, max_abs_err=e))
            del q, k, v
    main = next(r for r in rows if r["tokens"] == 6000
                and r["dtype"] == "bfloat16")
    return dict(name="prefill_attention", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:74",
                max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"],
                library_backend=main["library_backend"], shape=main["shape"],
                by_shape=rows)


def attention_flops(pairs, nq, hd):
    """(forward, backward) flops of attention over ``pairs`` (q, k) pairs
    per head: QK^T and PV in the forward (4 hd a pair), those two again
    with dP = dO V^T, dV = P^T dO, dK = dS^T Q and dQ = dS K in the
    backward (10 hd a pair: five products)."""
    return 4 * hd * nq * pairs, 10 * hd * nq * pairs


#: K4's backward kernels for each dtype, as the trace names them
BWD_KERNELS = {torch.bfloat16: ("flash_bwd_dkdv_wgmma_kernel",
                                "flash_bwd_dq_wgmma_kernel"),
               torch.float32: ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")}


def assert_bwd_kernels(rows, dtype):
    """The backward kernels in a trace's rows are ``dtype``'s and only
    those (a name is matched up to its template arguments); returns their
    rows."""
    names = [n for n, _ in rows if "flash_bwd_" in n and "prep" not in n]
    want = BWD_KERNELS[dtype]
    ran = {w for w in want for n in names if f"{w}<" in n}
    stray = [n for n in names if not any(f"{w}<" in n for w in want)]
    assert ran == set(want) and not stray, (dtype, names)
    return [(n, ms) for n, ms in rows if "flash_bwd_" in n]


def check_flash_bwd(danube, yi, llama4, zamba2):
    """K4's backward against its plain version on the card, on the same o,
    LSE and dO: at danube's training sequence (8,192 tokens, twice its
    window), yi-6b's heads at 2,048 tokens, Llama-4's heads across its
    8,192-token chunk, zamba2-7b's MHA at hd 112, and a small f32 case.
    The forward's LSE is held to the plain LSE, and a second forward's
    output and LSE to the first's bit for bit (the recompute in the
    backward pass must read what the pass saw); in bf16 a second backward
    to the first bit for bit (no atomics), and a traced backward must run
    the wgmma kernels and no other backward kernel.  At the training
    shape: the forward with its LSE and the backward timed, beside their
    plain versions, their bounds (operations: 4 hd and 10 hd flops a kept
    pair over the bf16 tensor-core rate) and the library yardstick,
    ``scaled_dot_product_attention`` forward, forward plus backward, and
    its backward alone (``torch.autograd.grad`` of one forward, the graph
    kept; K and V repeated to the q heads, the window as a boolean mask).
    Returns (the backward's kernel entry, the forward-with-LSE row)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    window = dict(sliding_window=danube.sliding_window)
    shapes = [("h2o-danube-3-4b training sequence", danube, 8192,
               torch.bfloat16, window),
              ("yi-6b heads", yi, 2048, torch.bfloat16, {}),
              (f"{LLAMA4} heads across its chunk", llama4, 8800,
               torch.bfloat16, dict(attention_chunk=llama4.attention_chunk)),
              ("zamba2-7b MHA at hd 112", zamba2, 1032, torch.bfloat16, {}),
              ("yi-6b heads in f32, window 100", yi, 300, torch.float32,
               dict(sliding_window=100))]
    rows, err, fwd_row = [], 0.0, None
    for label, cfg, n, dtype, masks in shapes:
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        pos = torch.arange(n, dtype=torch.int32, device="cuda")[None]
        q, k, v, do = (torch.randn((1, n, h, hd), generator=gen,
                                   device="cuda").to(dtype)
                       for h in (nq, nkv, nkv, nq))
        o, lse = fops._launch_forward(q, k, v, pos, pos, want_lse=True,
                                      **masks)
        o2, lse2 = fops._launch_forward(q, k, v, pos, pos, want_lse=True,
                                        **masks)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), label
        _, lse_p = fops.prefill_attention_plain(q, k, v, pos, pos,
                                                return_lse=True, **masks)
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
        lse_err = _max_err(lse, lse_p)
        del o2, lse2, lse_p
        got = fops.prefill_attention_bwd(q, k, v, o, lse, do, pos, pos,
                                         **masks)
        if dtype == torch.bfloat16:
            again = fops.prefill_attention_bwd(q, k, v, o, lse, do, pos, pos,
                                               **masks)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), label
            del again
        traced = assert_bwd_kernels(trace_rows(
            lambda: fops.prefill_attention_bwd(q, k, v, o, lse, do, pos, pos,
                                               **masks), 1), dtype)
        ref = fops.prefill_attention_bwd_plain(q, k, v, o, lse, do, pos, pos,
                                               **masks)
        torch.cuda.synchronize()
        errs = []
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.float(), r.float(),
                                       **FLASH_TOL[dtype])
            errs.append(_max_err(g, r))
        del got, ref
        err = max(err, *errs)
        pairs = int(fops.band_mask(pos, pos, masks.get("sliding_window"),
                                   masks.get("attention_chunk")).sum())
        print(f"  prefill_attention_bwd {label} ({n} tokens, {nq}/{nkv} "
              f"heads, hd {hd}, {str(dtype)[6:]}, {pairs} pairs per head): "
              f"max_abs_err dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv "
              f"{errs[2]:.3g} (tolerance {FLASH_TOL[dtype]}); forward LSE "
              f"{lse_err:.3g} from the plain LSE (rtol 1e-5, atol 1e-4), "
              f"a second forward bit-identical"
              + (", a second backward bit-identical"
                 if dtype == torch.bfloat16 else "")
              + "; kernels " + ", ".join(f"{n[:50]} {ms:.4f} ms"
                                         for n, ms in traced))
        row = dict(shape=label, tokens=n, dtype=str(dtype)[6:],
                   pairs_per_head=pairs, max_abs_err=max(errs))
        if not rows:
            elem = q.element_size()
            fwd_flops, bwd_flops = attention_flops(pairs, nq, hd)
            fwd_bytes = elem * n * hd * (2 * nq + 2 * nkv) + 4 * n * nq
            bwd_bytes = elem * n * hd * (4 * nq + 4 * nkv) + 4 * n * nq
            f_ms, _ = time_ms(lambda: fops._launch_forward(
                q, k, v, pos, pos, want_lse=True, **masks), 5)
            f_plain, _ = time_ms(lambda: fops.prefill_attention_plain(
                q, k, v, pos, pos, return_lse=True, **masks), 2, warmup=1)
            b_ms, _ = time_ms(lambda: fops.prefill_attention_bwd(
                q, k, v, o, lse, do, pos, pos, **masks), 3, warmup=1)
            b_plain, _ = time_ms(lambda: fops.prefill_attention_bwd_plain(
                q, k, v, o, lse, do, pos, pos, **masks), 2, warmup=1)
            gq = nq // nkv
            qt = q.transpose(1, 2).contiguous().requires_grad_()
            kt, vt = (t.repeat_interleave(gq, dim=2).transpose(1, 2)
                      .contiguous().requires_grad_() for t in (k, v))
            dot = do.transpose(1, 2).contiguous()
            band = fops.band_mask(pos[0], pos[0], **masks)

            def lib_fwd():
                with torch.no_grad():
                    return sdpa(qt, kt, vt, attn_mask=band)

            def lib_fwd_bwd():
                out = sdpa(qt, kt, vt, attn_mask=band)
                return torch.autograd.grad(out, (qt, kt, vt), dot)

            lib_out = sdpa(qt, kt, vt, attn_mask=band)

            def lib_bwd():
                return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                           retain_graph=True)

            lf_ms, _ = time_ms(lib_fwd, 3, warmup=1)
            lb_ms, _ = time_ms(lib_fwd_bwd, 3, warmup=1)
            lbo_ms, _ = time_ms(lib_bwd, 3, warmup=1)
            backend = top_kernel(lib_fwd_bwd)
            del qt, kt, vt, dot, band, lib_out
            fb, fb_by = bound(fwd_bytes, fwd_flops, BF16_FLOPS)
            bb, bb_by = bound(bwd_bytes, bwd_flops, BF16_FLOPS)
            print(f"  prefill_attention forward with LSE, {label}: {f_ms:.4f} "
                  f"ms device; plain {f_plain:.4f}; library (forward) "
                  f"{lf_ms:.4f}; bound {fb:.4f} ({fb_by}, "
                  f"{fwd_flops / 1e9:.1f} GFLOP)")
            print(f"  prefill_attention_bwd, {label}: {b_ms:.4f} ms device "
                  f"(three kernels); plain {b_plain:.4f}; library backward "
                  f"alone {lbo_ms:.4f}, forward plus backward {lb_ms:.4f} "
                  f"[{backend[:60]}]; bound {bb:.4f} ({bb_by}, "
                  f"{bwd_flops / 1e9:.1f} GFLOP); "
                  f"{bwd_flops / b_ms / 1e9:.1f} TFLOP/s")
            fwd_row = dict(shape=label, tokens=n, dtype="bfloat16",
                           ms=f_ms, plain_ms=f_plain, library_ms=lf_ms,
                           library_backend="scaled_dot_product_attention "
                           "forward, boolean band mask", bound_ms=fb,
                           bound_by=fb_by, max_abs_err=lse_err)
            row.update(ms=b_ms, plain_ms=b_plain, library_ms=lbo_ms,
                       library_fwd_bwd_ms=lb_ms, library_backend=backend,
                       bound_ms=bb, bound_by=bb_by,
                       kernels_ms={n[:50]: ms for n, ms in traced})
        rows.append(row)
        del q, k, v, do, o, lse
    main = rows[0]
    return dict(name="prefill_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/models/layers.py:151",
                note="no Pallas counterpart: the JAX package differentiates "
                "layers.chunked_attention with XLA; this is that gradient",
                max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"],
                library_fwd_bwd_ms=main["library_fwd_bwd_ms"],
                library_backend="scaled_dot_product_attention's backward "
                "(torch.autograd.grad of one forward; the forward plus "
                "backward in library_fwd_bwd_ms): " + main["library_backend"],
                shape=main["shape"], by_shape=rows), fwd_row


# ---------------------------------------------------------------------------
# phases 4 to 6: the serving paths
# ---------------------------------------------------------------------------


def serve(cfg, params, device, *, num_requests, local_slots, peer_budget,
          max_batch, bs=8, max_new_tokens=16, prompt=(5, 40)):
    """Serve a seeded Poisson workload (a latency tenant kept at full
    precision and a batch tenant demoted at int8) through the front door;
    returns (server, stats, per-step decode wall times, per-prefill wall
    times)."""
    runtime = HarvestRuntime({1: peer_budget})
    server = runtime.server(cfg, params, max_batch=max_batch, block_size=bs,
                            num_local_slots=local_slots, scheduler="fair",
                            mode="async", fidelity_policy="slo",
                            device=device)
    eng = server.engine
    step_s, prefill_s = [], []
    compute, prefill_fn = eng._compute, eng._prefill_fn

    def timed_compute():
        t0 = time.perf_counter()
        logits = compute()
        if logits.is_cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        assert torch.isfinite(logits).all(), "non-finite logits"
        return logits

    def timed_prefill(p, batch):
        t0 = time.perf_counter()
        out = prefill_fn(p, batch)
        if out[0].is_cuda:
            torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    eng._compute = timed_compute
    eng._prefill_fn = timed_prefill
    stats = server.run(Workload(
        num_requests=num_requests, arrival="poisson", rate=2e4, seed=SEED,
        vocab=(3, min(cfg.vocab_size, 250)),
        tenants=(TenantSpec("latency", slo="latency", prompt_len=prompt,
                            max_new_tokens=max_new_tokens),
                 TenantSpec("batch", slo="batch", prompt_len=prompt,
                            max_new_tokens=max_new_tokens))))
    return server, stats, step_s, prefill_s


def peer_budget(cfg, bs, blocks=6):
    """``blocks`` blocks of the store's accounting (bf16 k and v of every
    layer): six are 3 MiB at full-width yi-6b, 9 MiB at qwen2-moe.  With
    10 local slots and 4 rows, evictions reach the peer and, once it is
    full, the host."""
    return blocks * kv_block_bytes(cfg, bs)


def check_reduced_tokens(arch, prompt=(5, 40), local_slots=10, **changes):
    """A reduced model (with ``changes`` to its reduced config) on the CPU
    (plain versions) and on the card (kernels).  The weights are f32 here:
    with bf16 logits a near tie can flip on a rounding step between two
    GEMM libraries; in f32 the rounding noise is far below any gap, so
    identical tokens show the kernels right.  A model with KV blocks must
    have evicted some; one without (xLSTM) allocates none and launches no
    kernel."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    params = _map(M.init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu"), lambda t: t.float())
    runs = {}
    for fn in COUNTERS.values():
        fn.launches = 0
    for device in ("cpu", "cuda"):
        p = _map(params, lambda t: t.to(device))
        # the main path's geometry at the reduced block size: evictions to
        # peer and host, int8 demotions
        server, stats, _, _ = serve(cfg, p, device, num_requests=6,
                                    local_slots=local_slots,
                                    peer_budget=peer_budget(cfg, 8),
                                    max_batch=4, prompt=prompt)
        stats.check_clock_identity()
        runs[device] = ([h.tokens for h in server.handles],
                        dict(server.engine.kv_mgr.stats), stats.clock_s)
    assert runs["cpu"] == runs["cuda"], runs
    kv = runs["cuda"][1]
    if M.num_kv_layers(cfg):
        assert kv["evict_to_peer"] + kv["evict_to_host"] > 0, kv
    else:
        assert kv["allocated"] == 0, kv
        assert not any(fn.launches for fn in COUNTERS.values())
    return runs["cuda"][0]


#: reduced training in bf16, card against CPU (check_reduced_training).
#: Both run the same bf16 graph; they differ where a product sums its
#: bf16 terms in another order, so by a bf16 rounding here and there:
#: the f32 loss over 320 tokens to rtol 1e-3, grad_norm to one bf16 epsilon
#: (2^-7), each leaf's first moment (AdamW's mu, 0.1 g at step 1) within
#: 2^-5 of the leaf's largest entry (twice the port-vs-JAX bf16 gradient
#: tolerance: step 2 starts from parameters that AdamW's sign noise
#: moved), the second (0.001 g^2) within 2^-4.  A dropped gradient leaves a
#: leaf's moments at 0, off by its whole size.  A card run in f32 would
#: move these numbers no more than the rounding does (measured on the CPU:
#: loss 6e-6 and 6e-5, grad_norm 1e-3, mu 1.6e-2 of the leaf's largest),
#: so the card's dtypes and the backward kernels that ran are asserted
#: instead.
BF16_TRAIN_TOL = dict(loss=1e-3, nll=1e-3, grad_norm=2.0 ** -7,
                      mu=2.0 ** -5, nu=2.0 ** -4)


def _train_steps(params, batches, cfg, lr, device):
    """``train_step`` over ``batches`` on ``device`` from a copy of
    ``params``: ([metrics per step], the parameters' leaves after the last
    step, [(mu's leaves, nu's leaves) after each step]), all on the
    CPU."""
    p = _map(params, lambda t: t.clone().to(device))
    opt = adamw_init(p)
    hist, moments = [], []
    for b in batches:
        p, opt, m = train_step(p, opt, {k: torch.from_numpy(v).to(device)
                                        for k, v in b.items()}, cfg, lr=lr)
        hist.append({k: float(v) for k, v in m.items()})
        # copies: the update works in place, and .cpu() of a CPU tensor is
        # the tensor itself
        moments.append(([t.to("cpu", copy=True) for t in tree_leaves(opt.mu)],
                        [t.to("cpu", copy=True) for t in tree_leaves(opt.nu)]))
    return hist, [t.to("cpu", copy=True) for t in tree_leaves(p)], moments


def _leaf_rel(ref, run):
    """The largest |run - ref| of each leaf over its largest |ref|."""
    return [float((b.float() - a.float()).abs().max()
                  / a.float().abs().max().clamp_min(1e-30))
            for a, b in zip(ref, run)]


def hold_training(ref, run, dtype, lr):
    """Holds ``run`` (``_train_steps``'s result) to ``ref``.  f32: loss,
    nll and grad_norm to rtol 1e-5; the moments after each step within
    1e-4 of each leaf's largest entry; the parameters all within 2 lr a
    step and all but 1e-3 of them within 2e-6: AdamW moves a parameter by
    about +-lr whatever |g| while |g| >> eps, so an entry whose gradient
    sits near eps or within the two runs' f32 noise of 0 is moved by that
    noise.  bf16: ``BF16_TRAIN_TOL``, and the parameters each within 2 lr
    a step plus a bf16 epsilon of their size.  Returns what it measured
    for the print."""
    (h_ref, p_ref, m_ref), (h_run, p_run, m_run) = ref, run
    bf16 = dtype == torch.bfloat16
    tol = BF16_TRAIN_TOL if bf16 else dict(loss=1e-5, nll=1e-5,
                                           grad_norm=1e-5, mu=1e-4, nu=1e-4)
    for a, b in zip(h_ref, h_run):
        assert all(np.isfinite(list(b.values()))), b
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(b[key], a[key], rtol=tol[key],
                                       err_msg=key)
    worst_mom = {"mu": 0.0, "nu": 0.0}
    for (mu_a, nu_a), (mu_b, nu_b) in zip(m_ref, m_run):
        for key, a, b in (("mu", mu_a, mu_b), ("nu", nu_a, nu_b)):
            rel = _leaf_rel(a, b)
            worst_mom[key] = max(worst_mom[key], max(rel))
            assert max(rel) <= tol[key], (key, rel)
    step = 2 * lr * len(h_ref)
    off = total = 0
    worst = 0.0
    for a, b in zip(p_ref, p_run):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        off += int((d > 2e-6).sum())
        total += d.numel()
        if bf16:
            assert bool((d <= step + 2.0 ** -7
                         * torch.maximum(a.abs(), b.abs())).all())
    assert bf16 or (worst <= step and off <= 1e-3 * total), \
        (worst, off, total)
    return dict(moments=worst_mom, worst=worst, off=off, total=total)


def check_reduced_training(arch="h2o-danube-3-4b", dtype=torch.float32,
                           steps=2, batch=2, seq_len=160, lr=1e-3):
    """A reduced model (danube's: window 64, so the 160-token sequences
    cross it) trained ``steps`` AdamW steps on the CPU (plain versions)
    and on the card (K4's forward and backward kernels: f32 on the CUDA
    cores, bf16 on the tensor cores) from the same weights (f32, or the
    seed's bf16) and batches, held by ``hold_training``.  On the card K4
    must launch twice a layer a step (the pass and the recompute in the
    backward) and its backward once, and the profile must show the
    backward's kernels for ``dtype`` and no other backward kernel."""
    cfg = get_config(arch).reduced()
    params = _map(M.init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu"), lambda t: t.to(dtype))
    batches = list(make_batches(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                                seed=SEED), batch, seq_len,
                                num_batches=steps))
    ref = _train_steps(params, batches, cfg, lr, "cpu")
    for fn in COUNTERS.values():
        fn.launches = 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run = _train_steps(params, batches, cfg, lr, "cuda")
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    L = cfg.num_layers
    assert launches == dict({n: 0 for n in COUNTERS}, prefill_attention=2 * L
                            * steps, prefill_attention_bwd=L * steps), \
        launches
    assert all(t.dtype == dtype for t in run[1]), {t.dtype for t in run[1]}
    # the backward's kernels for the dtype ran, the other dtype's did not
    ran = assert_bwd_kernels(device_rows(prof, 1), dtype)
    got = hold_training(ref, run, dtype, lr)
    name = str(dtype).removeprefix("torch.")
    kernels = ", ".join(sorted(n[:40] for n, _ in ran))
    print(f"reduced {arch} trained {steps} steps in {name} on cpu and cuda: "
          f"losses {[round(h['loss'], 6) for h in ref[0]]} / "
          f"{[round(h['loss'], 6) for h in run[0]]}, grad_norm "
          f"{[round(h['grad_norm'], 6) for h in ref[0]]} / "
          f"{[round(h['grad_norm'], 6) for h in run[0]]}; moments per leaf "
          f"within {got['moments']['mu']:.3g} (mu) and "
          f"{got['moments']['nu']:.3g} (nu) of the leaf's largest; "
          f"parameters: {got['off']} of {got['total']} past 2e-6, largest "
          f"difference {got['worst']:.3g}; K4 launches "
          f"{launches['prefill_attention']} forward, "
          f"{launches['prefill_attention_bwd']} backward ({kernels})")


def check_no_backward():
    """Every kernel without a backward (K1, K2, K3, K5, K6, K7) raises on
    a CUDA tensor that requires grad in grad mode, naming itself, and runs
    under ``torch.no_grad``; none returns a tensor that drops the
    gradient."""
    dev = "cuda"
    q = torch.randn((2, 8, 64), device=dev, requires_grad=True)
    pool = torch.randn((4, 8, 2, 64), device=dev, requires_grad=True)
    req = torch.tensor([0, 0, 1, -1], dtype=torch.int32, device=dev)
    base = torch.tensor([0, 8, 0, 0], dtype=torch.int32, device=dev)
    pos = torch.tensor([12, 5], dtype=torch.int32, device=dev)
    flat = torch.randn((4, 64), device=dev, requires_grad=True)
    ids = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    values, scales = hops.quantize_blocks(flat.detach(), ids)
    xd, wi, wg, wo = (torch.randn(s, device=dev, requires_grad=True)
                      for s in ((2, 16, 32), (2, 32, 48), (2, 32, 48),
                                (2, 48, 32)))
    calls = {
        "paged_decode_partials": lambda: pops.paged_decode_partials(
            q, pool, pool, req, base, pos, scale=0.125),
        "quantize_blocks": lambda: hops.quantize_blocks(flat, ids),
        "dequantize_blocks": lambda: hops.dequantize_blocks(
            flat, values, scales, ids),
        "gather_blocks": lambda: hops.gather_blocks(flat, ids),
        "copy_blocks": lambda: hops.copy_blocks(flat, flat.detach().clone(),
                                                ids, ids),
        "moe_ffn": lambda: mops.moe_ffn(xd, wi, wg, wo)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert f"{name}: the kernel has no backward" in str(e), e
        else:
            raise AssertionError(f"{name} cut a gradient without raising")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    print(f"kernels without a backward raise under grad on the card: "
          f"{', '.join(calls)}")


def _model_flops(cfg, n_params, tokens, pairs):
    """A training step's flops: 6 per parameter per token for the pass and
    the backward, 2 more for the recomputed pass, the embedding's gather
    left out; attention's products over the kept pairs, forward twice."""
    gemm = 8 * (n_params - cfg.vocab_size * cfg.d_model) * tokens
    fwd, bwd = attention_flops(pairs, cfg.num_heads, cfg.resolved_head_dim)
    return gemm + cfg.num_layers * (2 * fwd + bwd)


def train_path(arch="h2o-danube-3-4b", steps=5, batch=1, seq_len=8192,
               lr=3e-4, warmup=100, total=1000):
    """Full-width training on the card: ``abstract_params`` reckons the
    footprint (parameters and their gradients in bf16, AdamW's two f32
    moments) before anything is allocated; then weights from the seed and
    ``steps`` fused steps (``train_step``: loss, gradients through K4's
    forward and backward, AdamW) on ``make_batches``'s sequences, each
    step timed on the host clock around a synchronised step, the learning
    rate ``train``'s schedule (``cosine_lr``) at the first steps of a
    ``warmup``-step warmup to ``lr``.  The launch
    counts are set to 0 just before the steps and read just after: K4's
    forward twice a layer a step (the pass and the recompute), its
    backward once, and no other kernel.  Then one step profiled for where
    the time goes.  Returns (launch counts, the numbers kept)."""
    cfg = get_config(arch)
    ap = M.abstract_params(cfg)
    n_params = M.param_count(ap)
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(ap))
    state = 2 * p_bytes + 8 * n_params
    layer_in = batch * seq_len * cfg.d_model * 2
    print(f"{arch} training: {n_params / 1e9:.3f} B parameters; reckoned "
          f"before allocating: parameters {p_bytes / 1e9:.2f} GB, gradients "
          f"{p_bytes / 1e9:.2f} GB (the parameters' dtype), AdamW moments "
          f"{8 * n_params / 1e9:.2f} GB (f32): {state / 1e9:.2f} GB "
          f"({state / 2 ** 30:.2f} GiB), plus the layer inputs kept for the "
          f"recompute ({cfg.num_layers} x {layer_in / 1e6:.0f} MB), one "
          f"layer's recompute and the loss's (b, s, V) f32 temporaries "
          f"({batch * seq_len * cfg.vocab_size * 4 / 1e9:.2f} GB each)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    print(f"{arch} training: weights and moments on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    batches = make_batches(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                           seed=SEED), batch, seq_len)

    def next_batch():
        return {k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}

    pos = torch.arange(seq_len, dtype=torch.int32, device="cuda")[None]
    pairs = int(fops.band_mask(pos, pos, cfg.sliding_window,
                               cfg.attention_chunk).sum())
    flops = _model_flops(cfg, n_params, batch * seq_len, pairs)
    for fn in COUNTERS.values():
        fn.launches = 0
    walls, hist = [], []
    for step in range(steps):
        b = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur_lr = cosine_lr(step, base=lr, warmup=warmup, total=total)
        params, opt, m = train_step(params, opt, b, cfg, lr=cur_lr)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in m.items()}
        assert all(np.isfinite(list(vals.values()))), vals
        hist.append(vals)
        print(f"  step {step}: {walls[-1] * 1e3:.1f} ms wall, "
              f"{batch * seq_len / walls[-1]:.0f} tokens/s, loss "
              f"{vals['loss']:.5f}, nll {vals['nll']:.5f}, grad_norm "
              f"{vals['grad_norm']:.5f}, lr {cur_lr:.2e}")
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    L = cfg.num_layers
    expect = dict({n: 0 for n in COUNTERS},
                  prefill_attention=2 * L * steps,
                  prefill_attention_bwd=L * steps)
    print(f"{arch} training: launches {launches} (predicted: K4 forward "
          f"{2 * L} and backward {L} a step, nothing else)")
    assert launches == expect, (launches, expect)
    assert int(opt.step) == steps
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(walls[1:]))
    mfu = flops / steady / BF16_FLOPS
    print(f"{arch} training: step wall {steady * 1e3:.1f} ms (mean of steps "
          f"1-{steps - 1}; step 0 {walls[0] * 1e3:.1f} ms), "
          f"{batch * seq_len / steady:.0f} tokens/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB), model flops "
          f"{flops / 1e12:.1f} TFLOP a step (8 x {n_params / 1e9:.3f} B "
          f"less the embedding x {batch * seq_len} tokens, attention over "
          f"{pairs} pairs a head), {100 * mfu:.1f}% of the bf16 peak")
    b = next_batch()
    rows = trace_rows(lambda: train_step(params, opt, b, cfg, lr=cur_lr), 1)
    assert_bwd_kernels(rows, torch.bfloat16)
    busy = sum(ms for _, ms in rows)
    k4f = sum(ms for n, ms in rows if "flash_prefill" in n)
    k4b = sum(ms for n, ms in rows if "flash_bwd" in n)
    print(f"{arch} training: one step profiled: {busy:.1f} ms device-busy "
          f"({100 * busy / (steady * 1e3):.1f}% of the mean step wall), K4 "
          f"forward {k4f:.1f} ms, K4 backward {k4b:.1f} ms")
    for name, ms in rows[:8]:
        print(f"  {ms:9.3f} ms/step  {name[:90]}")
    del params, opt, b
    gc.collect()
    torch.cuda.empty_cache()
    check_no_backward()
    return launches, dict(steps=steps, tokens_per_step=batch * seq_len,
                          step_ms=[w * 1e3 for w in walls],
                          steady_step_ms=steady * 1e3,
                          tokens_per_s=batch * seq_len / steady,
                          peak_gib=peak / 2 ** 30, mfu=mfu,
                          device_busy_ms=busy, k4_forward_ms=k4f,
                          k4_backward_ms=k4b,
                          losses=[h["loss"] for h in hist],
                          grad_norms=[h["grad_norm"] for h in hist])


def _tensors(tree):
    """The tensors of nested tuples (the recurrent states)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for part in tree for t in _tensors(part)]


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def device_rows(prof, steps):
    """[(kernel name, device ms per step)] of a profile's device-side rows
    (kernels, memsets, copies), largest first.  The runtime calls' rows are
    left out: the profiler can hang a kernel's time on the runtime call
    that shares its correlation id (a cudaFuncSetAttribute before the
    launch), which would name that call as the kernel and count the
    kernel's time twice."""
    from torch.autograd import DeviceType
    rows = [(row.key, getattr(row, "self_device_time_total",
                              getattr(row, "self_cuda_time_total", 0.0))
             / 1e3 / steps) for row in prof.key_averages()
            if row.device_type != DeviceType.CPU]
    rows.sort(key=lambda kv: -kv[1])
    return rows


def profile_decode_step(cfg, params, bs, pos=(41, 24, 33, 17), n_slots=20,
                        steps=5):
    """Where one full-width decode step's time goes: one row per entry of
    ``pos`` (its position) over a pool of ``n_slots`` slots, each row
    owning the slots its positions need, the step run ``steps`` times
    under the profiler, from zero recurrent states where the model has
    them (a pool only where it has KV layers).  Returns (wall ms per step,
    device-busy ms per step, [(kernel name, device ms per step)] of the
    five largest, the pools and the slot table as K1 sees them)."""
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    L, nkv, hd = M.num_kv_layers(cfg), cfg.num_kv_heads, \
        cfg.resolved_head_dim
    b = len(pos)
    pool = torch.randn((2, L, n_slots, bs, nkv, hd), generator=gen,
                       device="cuda") if L else None
    slot_req = np.full((n_slots,), -1, np.int32)
    slot_base = np.zeros((n_slots,), np.int32)
    append_slot = np.zeros((b,), np.int32)
    slot = 0
    for r, p in enumerate(pos):
        for j in range(p // bs + 1):
            slot_req[slot], slot_base[slot] = r, j * bs
            if j == p // bs:
                append_slot[r] = slot
            slot += 1
    assert slot <= n_slots, (slot, n_slots)
    dev = {k: torch.from_numpy(v).cuda() for k, v in dict(
        slot_req=slot_req, slot_base=slot_base, append_slot=append_slot,
        append_off=np.asarray(pos, np.int32) % bs,
        pos=np.asarray(pos, np.int32),
        tokens=rng.integers(3, 250, size=b).astype(np.int32)).items()}
    state = M.DecodeState(
        tokens=dev["tokens"], pos=dev["pos"], peer=None, kv=M.KVPools(
            pool[0], pool[1], dev["slot_req"], dev["slot_base"],
            dev["append_slot"], dev["append_off"]) if L else None,
        states=M.init_states(cfg, b, "cuda"))

    def step():
        logits, _ = M.serve_step(params, state, cfg)
        logits.float().cpu()        # the engine samples on the host

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = trace_rows(step, steps)
    return wall_ms, sum(ms for _, ms in rows), rows[:5], (pool, dev)


def profile_prefill(cfg, params, n):
    """One full-width prefill of ``n`` tokens (the engine's forward): wall
    ms, device-busy ms and K4's device ms, from one profiled call after a
    warm-up call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batch = {"tokens": torch.randint(3, 250, (1, n), generator=gen,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.arange(n, dtype=torch.int32,
                                       device="cuda")[None]}

    def prefill():
        return M.forward(params, batch, cfg, want_kv=True)

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = trace_rows(prefill, 1)
    k4 = sum(ms for name, ms in rows if "flash_prefill" in name)
    return wall_ms, sum(ms for _, ms in rows), k4


def long_pool_k1(cfg, pools, bs):
    """K1 at the long path's pool size: the profiled decode step's pools
    (the rows' positions and slot table as there), held to the plain
    version on layer 0 and timed two ways: cycling through the step's
    layers, so that each call finds its pool cold as in the step (the
    number kept), and on layer 0 alone, where part of the 63 MB of live
    rows stays in the 50 MB L2 between calls.  The bound counts the k and
    v rows of the positions the window keeps, read from device memory."""
    pool, dev = pools
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b = dev["pos"].shape[0]
    L = pool.shape[1]
    q = torch.randn((b, nq, hd), generator=gen, device="cuda")
    rest = (dev["slot_req"], dev["slot_base"], dev["pos"])
    kw = dict(scale=hd ** -0.5, sliding_window=cfg.sliding_window,
              attention_chunk=cfg.attention_chunk)
    got = pops.paged_decode_partials(q, pool[0, 0], pool[1, 0], *rest, **kw)
    ref = pops.paged_decode_partials_plain(q, pool[0, 0], pool[1, 0], *rest,
                                           **kw)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    layer = [0]

    def cycled():
        i = layer[0] = (layer[0] + 1) % L
        pops.paged_decode_partials(q, pool[0, i], pool[1, i], *rest, **kw)

    ms, ms_wall = time_ms(cycled, 2 * L)
    warm_ms, _ = time_ms(lambda: pops.paged_decode_partials(
        q, pool[0, 0], pool[1, 0], *rest, **kw), 50)
    n_slots = dev["slot_req"].shape[0]
    bound_ms, bound_by = k1_bound(dev["pos"].tolist(), n_slots, nq, nkv, hd,
                                  cfg.sliding_window, cfg.attention_chunk)
    owned = int((dev["slot_req"] >= 0).sum())
    splits = pops.num_splits(b, nkv, n_slots, pops.sm_count(q.device))
    return (f"K1 at the long path's pool ({n_slots} slots of {bs}, {owned} "
            f"owned, positions {dev['pos'].tolist()}, {splits} splits per "
            f"(request, kv head)): {ms:.5f} ms device cycling through the "
            f"{L} layers' pools, {ms_wall:.5f} between events; {warm_ms:.5f} "
            f"on one layer's pool (partly in L2); bound {bound_ms:.6f} "
            f"({bound_by})"), \
        dict(ms=ms, warm_ms=warm_ms, bound_ms=bound_ms, n_slots=n_slots,
             splits=splits)


#: every kernel's wrapper, by the name in the kernels line
COUNTERS = {"paged_decode_partials": pops.paged_decode_partials,
            "quantize_demote": hops.quantize_blocks,
            "dequantize_reload": hops.dequantize_blocks,
            "prefill_attention": fops.prefill_attention,
            "gather_blocks": hops.gather_blocks,
            "copy_blocks": hops.copy_blocks,
            "moe_ffn": mops.moe_ffn,
            "prefill_attention_bwd": fops.prefill_attention_bwd}


#: what one eviction may put on the card: K6 (twice), K2 and K3 (a
#: quantized block) and the payload's one copy to the host
EVICTION_ROWS = ("gather_rows_kernel", "quantize_rows_kernel",
                 "dequantize_kernel", "Memcpy DtoH")


def profile_eviction(eng):
    """One eviction's device rows (the engine's ``_evict_payload`` of slot
    0, at int8 and at full fidelity): K6 and the quantized round trip
    only, with no id copied to the card and no copy of the payload on
    it."""
    for fid in (Fidelity.INT8, None):
        rows = traced_rows(lambda f=fid: eng._evict_payload(0, f), 5)
        print(f"  eviction at {fid.value if fid else 'full fidelity'}, "
              f"device ms per call: "
              f"{[(n[:40], round(t, 6)) for n, t in rows]}")
        assert all(any(k in n for k in EVICTION_ROWS) for n, _ in rows), \
            rows
        assert any("gather_rows_kernel" in n for n, _ in rows), rows
        assert (fid is None) != any("quantize_rows_kernel" in n
                                    for n, _ in rows), rows


def profile_reload(eng):
    """One reload's device rows as the engine's ``_on_reload`` makes them
    (its three lines repeated here on a full-fidelity payload of slot 0):
    the payload's copy from pageable host memory to a staging tensor on
    the card, then K5 once per pool, with no copy of its ids."""
    payload = eng._evict_payload(0, None)
    k_ids = 2 * np.arange(eng.L_kv, dtype=np.int32)

    def reload():
        staging = torch.from_numpy(np.ascontiguousarray(payload)).to(
            eng.device, eng.pool_k.dtype).view(2 * eng.L_kv, -1)
        eng._copy_slot((staging, k_ids), (staging, k_ids + 1), 0)

    rows = traced_rows(reload, 5)
    print(f"  reload of {payload.nbytes} B, device ms per call: "
          f"{[(n[:40], round(t, 6)) for n, t in rows]}")
    assert {("copy_rows_kernel" in n) + 2 * ("HtoD" in n) for n, _ in rows} \
        == {1, 2}, rows


def main_path(arch, bs, kernels_of_path, *, num_requests=6, local_slots=10,
              peer_blocks=6, max_batch=4, prompt=(5, 40),
              profile_pos=(41, 24, 33, 17), profile_slots=20,
              prefill_tokens=None, pool_k1=True, profile_evict=False,
              layers=None, on_model=None):
    """Serve the full-width model (its depth cut to ``layers`` if given)
    through the front door with the launch counts set to 0 just before and
    read just after; every kernel of the path must have launched, and a
    model without KV layers (xLSTM) must have allocated no block and
    launched no kernel.  Then ``on_model(cfg, params)`` if given, then
    profile one decode step (rows at ``profile_pos`` over
    ``profile_slots`` slots) and, given ``prefill_tokens``, one prefill of
    that length and, with ``pool_k1``, K1 at the profiled pool; given
    ``profile_evict``, one eviction and one reload of the served engine.
    Returns (launch counts, K1's numbers at that pool or None,
    ``on_model``'s result or None); the weights are freed on return."""
    full = get_config(arch)
    if layers:
        full = dataclasses.replace(full, num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(full, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    print(f"{arch} full width, {full.num_layers} layers: "
          f"{M.param_count(params) / 1e9:.3f} B params initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    server, stats, step_s, prefill_s = serve(
        full, params, "cuda", num_requests=num_requests,
        local_slots=local_slots,
        peer_budget=peer_budget(full, bs, peer_blocks), max_batch=max_batch,
        bs=bs, prompt=prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    eng = server.engine
    served = [h for h in server.handles if h.state == "done"]
    kv = dict(eng.kv_mgr.stats)
    print(f"{arch}: served {len(served)}/{len(server.handles)} requests, "
          f"{stats.tokens_out} tokens, kv {kv}")
    print(f"{arch}: fidelity {eng.runtime.stats().get('fid', {})}")
    print(f"{arch}: launches on the path: {launches}")
    assert len(served) == len(server.handles) == num_requests
    assert all(len(h.tokens) == 16 for h in served)
    if eng.L_kv:
        assert kv["evict_to_peer"] > 0 and kv["evict_to_host"] > 0, kv
        assert kv["reload_peer"] + kv["reload_host"] > 0, kv
    else:
        assert kv["allocated"] == 0, kv
        assert not any(launches.values()), launches
    assert all(launches[n] > 0 for n in kernels_of_path), launches
    stats.check_clock_identity()
    for h in served:
        assert all(0 <= tok < full.vocab_size for tok in h.tokens)
    decode_ms = 1e3 * float(np.mean(step_s))
    print(f"{arch}: decode step wall {decode_ms:.2f} ms (mean of "
          f"{len(step_s)}), {stats.tokens_out / wall:.1f} tokens/s wall over "
          f"{wall:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{arch}: prefill wall ms per call: "
          f"{[round(1e3 * t, 2) for t in prefill_s]} (prompt lengths "
          f"{[len(h._req.prompt) for h in server.handles]})")
    if eng.states is not None:
        leaves = _tensors(eng.states)
        mib = sum(t.numel() * t.element_size() for t in leaves) / 2 ** 20
        print(f"{arch}: recurrent states of the {eng.B} rows: {mib:.1f} MiB "
              f"({', '.join(str(t.dtype)[6:] for t in leaves)})")
    print(f"{arch}: simulated (H100/NVLink cost model, not the card): clock "
          f"{stats.clock_s * 1e3:.4f} ms, "
          f"{stats.tokens_out / stats.clock_s:.0f} tokens/s")
    if profile_evict:
        print(f"{arch}: one eviction and one reload profiled")
        profile_eviction(eng)
        profile_reload(eng)
    del server, eng
    extra = on_model(full, params) if on_model else None
    step_ms, busy_ms, top, pools = profile_decode_step(
        full, params, bs, profile_pos, profile_slots)
    print(f"{arch}: decode step profile ({len(profile_pos)} rows at "
          f"{list(profile_pos)}, {profile_slots} slots): {step_ms:.2f} ms "
          f"wall, {busy_ms:.2f} ms device-busy "
          f"({100 * busy_ms / step_ms:.1f}%)")
    for name, ms in top:
        print(f"  {ms:8.3f} ms/step  {name[:90]}")
    k1 = None
    if prefill_tokens:
        if pool_k1:
            line, k1 = long_pool_k1(full, pools, bs)
            print(f"{arch}: {line}")
        del pools
        wall_ms, busy_ms, k4_ms = profile_prefill(full, params,
                                                  prefill_tokens)
        print(f"{arch}: prefill profile ({prefill_tokens} tokens): "
              f"{wall_ms:.2f} ms wall, {busy_ms:.2f} ms device-busy "
              f"({100 * busy_ms / wall_ms:.1f}%), K4 {k4_ms:.2f} ms "
              f"({100 * k4_ms / busy_ms:.1f}% of device time, "
              f"{100 * k4_ms / wall_ms:.1f}% of wall)")
        print(f"{arch}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, k1, extra


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")

    t = build.build_all()
    print(f"build: {len(build.sources())} sources in {t:.1f} s")
    for name in build.sources():
        for fn, (regs, spills) in ptxas_by_kernel(
                build.ptxas_report(name)).items():
            print(f"  ptxas {name}: {fn}: {regs}; {spills}")
            if "mma" in fn:
                assert spills.startswith("0 bytes stack frame, 0 bytes spill "
                                         "stores, 0 bytes spill loads"), fn
        for line in build.ptxas_report(name).splitlines():
            if "serialized" in line:      # wgmma run one at a time
                print(f"  ptxas {name}: {line.strip()[:200]}")
    hmma = hmma_by_kernel(build.sass("flash_prefill"))
    print(f"  sass flash_prefill: HMMA instructions per kernel {hmma}")
    assert all(n > 0 for fn, n in hmma.items() if "mma" in fn), hmma
    assert any("mma" in fn for fn in hmma), hmma

    yi, moe = get_config("yi-6b"), get_config("qwen2-moe")
    danube = get_config("h2o-danube-3-4b")
    nemotron, command_r = get_config("nemotron-4-15b"), \
        get_config("command-r-35b")
    # Llama-4 served at two dense/MoE pairs of its 48 layers: one MoE
    # layer's experts are 32.2 GB, the whole model does not fit one card
    llama4 = dataclasses.replace(get_config(LLAMA4), num_layers=LLAMA4_LAYERS)
    qwen2_vl = dataclasses.replace(get_config(QWEN2_VL),
                                   num_layers=QWEN2_VL_LAYERS)
    dbrx = dataclasses.replace(get_config(DBRX), num_layers=DBRX_LAYERS)
    zamba2 = get_config(ZAMBA2)
    npre = qwen2_vl.modality.num_prefix_embeddings
    bs = 8
    # K1's 10-slot decode shape at Llama-4's 48 and qwen2-vl-72b's 80
    # layers, so that its pools cycle past the L2 as the other models' do
    kernels = [check_paged_decode(yi, bs, more=[nemotron, command_r,
                                                get_config(LLAMA4),
                                                get_config(QWEN2_VL), zamba2],
                                  chunked=[llama4])] \
        + check_quant([(yi, bs), (moe, bs), (danube, 16), (llama4, 16),
                       (command_r, bs), (nemotron, bs), (qwen2_vl, bs),
                       (dbrx, bs), (zamba2, bs)]) \
        + [check_flash_prefill(yi, moe, danube, more=[
            (f"{LLAMA4} prompt past its chunk", llama4, 8800,
             dict(attention_chunk=llama4.attention_chunk)),
            ("command-r-35b smoke prompt", command_r, 40, {}),
            ("nemotron-4-15b smoke prompt", nemotron, 40, {}),
            (f"{QWEN2_VL} {npre} prefix positions and a smoke prompt",
             qwen2_vl, npre + 40, {}),
            ("dbrx-132b smoke prompt", dbrx, 40, {}),
            ("zamba2-7b smoke prompt (MHA, hd 112)", zamba2, 40, {})])] \
        + check_movers([(yi, bs), (danube, 16), (llama4, 16),
                        (command_r, bs), (nemotron, bs), (qwen2_vl, bs),
                        (dbrx, bs), (zamba2, bs), (moe, bs)]) \
        + [check_moe_ffn(moe, get_config("phi-tiny-moe"))]
    k4_bwd, k4_train_fwd = check_flash_bwd(danube, yi, llama4, zamba2)
    kernels.append(k4_bwd)
    next(k for k in kernels if k["name"] == "prefill_attention")[
        "training_forward_with_lse"] = k4_train_fwd
    tolerance = {"paged_decode_partials": "rtol 1e-4, atol 1e-4 (f32 sums "
                 "in another order)", "quantize_demote": "bit-identical",
                 "dequantize_reload": "bit-identical",
                 "prefill_attention": "bf16 rtol 1.6e-2, atol 2^-7 (p "
                 "rounded against another running max); f32 rtol 1e-4, "
                 "atol 1e-4",
                 "gather_blocks": "bit-identical",
                 "copy_blocks": "bit-identical",
                 "moe_ffn": "bf16 rtol 1.6e-2, atol 2^-7; f32 rtol 1e-4, "
                 "atol 1e-4 (sums in another order than cuBLAS)",
                 "prefill_attention_bwd": "bf16 rtol 1.6e-2, atol 2^-7; f32 "
                 "rtol 1e-4, atol 1e-4 (each gradient rounded once from f32 "
                 "sums taken in another order)"}
    for k in kernels:
        print(f"kernel {k['name']}: ms {k['ms']:.5f}  plain_ms "
              f"{k['plain_ms']:.5f}  library_ms {k['library_ms']}  bound_ms "
              f"{k['bound_ms']:.6f} ({k['bound_by']})  max_abs_err "
              f"{k['max_abs_err']:.3g} against the plain version, tolerance "
              f"{tolerance[k['name']]}")

    # nemotron-4-15b keeps its GQA group of 6 (48 / 8) at 12 / 2 heads;
    # Llama-4 gets its interleaving back (reduced() sets layer_period 1),
    # with 4 layers and prompts past its reduced attention chunk of 64;
    # command-r-35b at 4 layers and 8 slots, where its requests overlap
    # (at 2 layers each one ends before the next arrives: no eviction)
    l4_moe = get_config(LLAMA4).reduced().moe
    for arch, prompt, slots, changes in (
            ("yi-6b", (5, 40), 10, {}),
            ("qwen2-moe", (5, 40), 10, {}),
            ("h2o-danube-3-4b", (70, 150), 24, {}),
            ("nemotron-4-15b", (5, 40), 8,
             dict(num_heads=12, num_kv_heads=2)),
            (LLAMA4, (70, 150), 24,
             dict(num_layers=4, moe=dataclasses.replace(l4_moe,
                                                        layer_period=2))),
            ("command-r-35b", (5, 40), 8, dict(num_layers=4)),
            (QWEN2_VL, (5, 40), 10, {}),
            (DBRX, (5, 40), 10, {}),
            # two super-blocks and a tail, 8 slots: its requests overlap
            (ZAMBA2, (5, 40), 8, dict(num_layers=5)),
            (XLSTM, (5, 40), 10, dict(num_layers=4))):
        tokens = check_reduced_tokens(arch, prompt, slots, **changes)
        label = {k: v for k, v in changes.items() if k != "moe"}
        if "moe" in changes:
            label["layer_period"] = changes["moe"].layer_period
        print(f"reduced {arch} {label or ''}: cpu and cuda tokens "
              f"identical ({tokens[:2]} ...)")
    check_reduced_training(dtype=torch.float32)
    check_reduced_training(dtype=torch.bfloat16)

    # ---- phases 5 to 10: the paths at full width ----
    movers = ["paged_decode_partials", "quantize_demote",
              "dequantize_reload", "prefill_attention", "gather_blocks",
              "copy_blocks"]
    paths = {}
    paths["yi-6b"], _, _ = main_path("yi-6b", bs, movers)
    paths["qwen2-moe"], _, _ = main_path("qwen2-moe", bs,
                                         movers + ["moe_ffn"])
    # the long-prompt path: 4 requests of 4,500-6,000 tokens (past the
    # 4,096-token window), 2 rows, 16-token blocks; 800 local slots hold
    # two requests' blocks, and each preemption evicts a request's 280-375
    # blocks past a peer budget of 64 into the host
    paths["h2o-danube-3-4b"], k1_long, _ = main_path(
        "h2o-danube-3-4b", 16, movers, num_requests=4, local_slots=800,
        peer_blocks=64, max_batch=2, prompt=(4500, 6000),
        profile_pos=(5999, 4700), profile_slots=800, prefill_tokens=6000,
        profile_evict=True)
    # Llama-4 at two dense/MoE pairs, the long path's geometry with
    # prompts of 8,300-8,800 tokens: prefill and decode cross the 8,192
    # attention chunk; K7 then runs at the decode shape on the model's own
    # experts (no room for a second copy of them)
    paths[LLAMA4], k1_llama4, k7_llama4 = main_path(
        LLAMA4, 16, movers + ["moe_ffn"], num_requests=4, local_slots=800,
        peer_blocks=64, max_batch=2, prompt=(8300, 8800),
        profile_pos=(8799, 8350), profile_slots=1100, prefill_tokens=8800,
        layers=LLAMA4_LAYERS, on_model=check_moe_ffn_experts)
    # command-r-35b (parallel blocks, all 40 layers) and nemotron-4-15b
    # (relu2, gq 6, all 32 layers) on yi-6b's workload
    paths["command-r-35b"], _, _ = main_path("command-r-35b", bs, movers)
    paths["nemotron-4-15b"], _, _ = main_path("nemotron-4-15b", bs, movers)
    # qwen2-vl-72b (every prefill 1,024 prefix positions ahead of the
    # prompt) and dbrx-132b at the depths that fit the card, on yi-6b's
    # workload; K7 then at DBRX's decode shape (4 rows, top-4 of 16) on the
    # model's own experts
    paths[QWEN2_VL], _, _ = main_path(QWEN2_VL, bs, movers,
                                      layers=QWEN2_VL_LAYERS)
    paths[DBRX], _, k7_dbrx = main_path(
        DBRX, bs, movers + ["moe_ffn"], layers=DBRX_LAYERS,
        on_model=lambda cfg, params: check_moe_ffn_experts(cfg, params,
                                                           rows=4))
    # zamba2-7b (81 Mamba2 layers, the shared attention block at 13 of
    # them: 13 KV layers, MHA at hd 112) and xlstm-1.3b (48 layers, no KV)
    # whole, on yi-6b's workload, each decode step carrying the batch's
    # recurrent states
    paths[ZAMBA2], _, _ = main_path(ZAMBA2, bs, movers, prefill_tokens=40,
                                    pool_k1=False)
    paths[XLSTM], _, _ = main_path(XLSTM, bs, [], prefill_tokens=40,
                                   pool_k1=False)
    # the training path: full-width h2o-danube-3-4b, 1 x 8,192 tokens
    # (twice its window) a step, through K4's forward and backward
    paths["h2o-danube-3-4b training"], training = train_path()
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] == "paged_decode_partials":
            k["long_pool"] = k1_long
            k["llama4_pool"] = k1_llama4
        if k["name"] == "prefill_attention_bwd":
            k["training"] = training
        if k["name"] == "moe_ffn":
            k["by_shape"] += [k7_llama4, k7_dbrx]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   k7_llama4["max_abs_err"],
                                   k7_dbrx["max_abs_err"])
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
