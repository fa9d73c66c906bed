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
     qwen2-vl-72b's, zamba2-7b's and musicgen-medium's full-width shapes,
     GQA groups of 6, 8, 5, 8, 1 and 1 (zamba2's MHA at head dim 112,
     musicgen's at 64), over a local and a peer pool merged by LSE as the
     in-place mode calls it (musicgen's rows, one row with no block on
     the peer),
     at a card-filling yi-6b
     pool of 65,536 slots holding 64 short contexts, and at Llama-4's heads
     with its 8,192-token attention chunk, rows on both sides of the
     boundary; prefill attention at 40-, 1,032- and 6,000-token prompts,
     an 8,800-token Llama-4 prompt past its chunk, Command-R's, Nemotron's,
     DBRX's and zamba2-7b's smoke prompts, qwen2-vl-72b's 1,024 prefix
     positions ahead of one and musicgen-medium's 64 ahead of a
     1,500-frame prompt (MHA at head dim 64), with a sliding window, an attention chunk and
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
     backward, and backward alone; the expert FFN's training forward
     (bf16 on wgmma, writing A, h and g) and its backward (bf16 on wgmma
     from the saved A, h and g, f32 on the CUDA cores) against their
     plain versions at phi-tiny-moe's training shape (8,192 routed
     tokens, C 1,280, one expert forced tokenless), qwen2-moe's and
     DBRX's widths and an odd d and f under each activation, bf16 twice
     and bit-identical, the tokenless experts' weight gradients exact
     zeros, the skipped tiles counted on the card, the kernels that ran
     read from a trace, the forward timed beside the bmm composition and
     its bound, the backward beside its plain version, its bound and the
     bmm composition's backward; one MoE layer's gradient at
     phi-tiny-moe's width taken twice, bit-identical;
  4. reduced yi-6b, qwen2-moe, h2o-danube-3-4b (prompts past its 64-token
     window), nemotron-4-15b at 12 / 2 heads (its GQA group of 6),
     Llama-4 at 4 layers with its dense/MoE interleaving (prompts past its
     64-token chunk), Command-R at 4 layers (parallel blocks), qwen2-vl-72b
     (M-RoPE, qkv bias, 8 prefix embeddings), DBRX, Mixtral (its reduced
     64-token window), Phi-3.5-MoE, zamba2-7b at 5 layers
     (two super-blocks of Mamba2 layers and the shared attention block,
     and a tail) and xlstm-1.3b at 4 layers (no KV: no block, no kernel)
     served on the CPU (plain versions) and on the card (kernels):
     identical tokens; then reduced h2o-danube-3-4b, phi-tiny-moe (at an
     odd expert width of 183), qwen2-moe and Llama-4 (4 layers, its
     interleaving) each trained two AdamW steps in f32 and in bf16 on the
     CPU and on the card from the same weights and batches (loss,
     grad_norm, moments and parameters at stated tolerances; K4's and
     K7's launches counted, K7's forward in bf16 the training forward);
     reduced musicgen-medium at model level (the engine refuses the audio
     family), each row prefilled alone, then 16 decode steps in fetch
     mode and 16 in place (half of each row's blocks on a peer pool), on
     the CPU and on the card: identical (step, row, codebook) tokens;
  5. the first path: full-width yi-6b (random weights from a seed) served
     through ``HarvestRuntime(...).server(...)`` with evictions, reloads and
     quantized demotions; every kernel of the path must have launched; then
     one decode step over random pools in fetch mode and in place (each
     row's first block on a peer pool; its launches a path of their own:
     K1 once a layer, twice in place), logits and argmax held and each
     mode profiled; then one full-width decode step profiled (wall time,
     device-busy share, the largest kernels);
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
     prefill attention's share; its in-place step (before the profiles)
     puts the first half of each row's blocks on the peer, inside and
     outside the window;
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
     timed at DBRX's decode shape on the model's own 16 experts; then
     mixtral-8x7b (8 experts top-2 of width 14,336, window 4,096) and
     phi-3.5-moe (16 top-2 of 6,400) at 16 of their 32 layers (23.48 B and
     21.07 B) and phi-tiny-moe whole (16 top-2 of 915, 3.81 B) the same
     way, the expert FFN at each decode shape on the model's own experts;
 11. zamba2-7b (81 Mamba2 layers and one shared attention block after
     every sixth: 13 KV layers, 6.75 B parameters) and xlstm-1.3b (48
     mLSTM and sLSTM blocks, no KV, 2.05 B) whole on yi-6b's workload,
     each decode step carrying the batch's recurrent states (their bytes
     printed); a decode step from zero states and a 40-token prefill
     profiled;
 12. sharded decode: two ranks (``launch``; NCCL where there are two
     cards, else gloo on the one) on the mesh (data 1, model 2), tensor
     parallel over model, decode full-width yi-6b, h2o-danube-3-4b and
     phi-tiny-moe at 4 layers each (``SHARD_LAYERS``, cut for the run's
     time) (yi-6b 4 rows over 24 slots of 8, 12 a rank; in fetch
     mode, and in place with each row's first block on a peer pool split
     the same way), h2o-danube-3-4b (rows at 5,999 and 4,700 over 800
     slots of 16, 400 a rank) and phi-tiny-moe (8 of 16 experts a rank) 8
     steps sharded and unsharded from the same weights and pools: the
     logits and appended k and v within stated tolerances, the tokens
     equal but for named near ties, each rank's pool shards the matching
     slots of the unsharded pools, K1 once a KV layer a step on each rank
     (twice in place) and K7 once an MoE layer over the rank's experts;
     phi-tiny-moe's rows its router sent elsewhere by itself named, its
     steps then held replayed under the unsharded routing; per rank the
     step's wall, one profiled step's device-busy ms and the collectives'
     host ms and share, the rank's parameter GiB against the whole
     model's and tensor parallelism's collectives a step;
 13. musicgen-medium whole (48 layers, 1.38 B parameters, bf16) at model
     level: 4 rows of 64 conditioning embeddings and 250-1,500 audio
     frames, each prefilled alone through K4 and placed into 16-token
     blocks, then 64 decode steps in fetch mode and 64 in place (the
     first half of each row's blocks on a peer pool) through K1, both fed
     the fetch mode's tokens: K4 48 launches a prefill, K1 48 a step and
     96 in place; the modes' (step, row, codebook) tokens equal but for
     named near ties; the in-place logits held to a full-sequence forward
     over the same tokens; each mode's step and one prefill profiled;
 14. the training path: full-width h2o-danube-3-4b (all 24 layers, 3.962
     B parameters) trained 5 AdamW steps of 1 x 8,192 tokens from the
     synthetic corpus, its footprint reckoned from ``abstract_params``
     before it is allocated, every block recomputed in the backward pass,
     attention's forward and backward through K4's kernels (48 forward
     and 24 backward launches a step, nothing else); each step's wall,
     tokens/s, loss and grad_norm, peak memory and the model-flops share
     of the bf16 peak printed, one step profiled (its trace must show the
     backward's wgmma kernels and no other backward kernel); then
     phi-tiny-moe the same way at full width and depth (32 layers, 16
     experts top-2 of width 915, 3.812 B parameters), through K4's and
     K7's forward and backward (64 + 32 launches of each a step; K7's
     forward the training forward, its profile without the decode
     kernels), the share of the peak from the flops of the experts a token
     passes through; then every kernel without a backward must raise when
     handed a tensor that requires grad, and K7's gradient must arrive;
 15. sharded training: four ranks (``launch``; NCCL where there are four
     cards, else gloo on the one) on the mesh (data 2, model 2), FSDP over
     data, the experts and tensor parallelism over model (the rank's
     parameter GiB against the whole model's and tensor parallelism's
     collectives printed): reduced phi-tiny-moe (2 of 4 experts
     a rank) and reduced yi-6b trained two AdamW steps on the card and on
     the CPU over that mesh, f32 and bf16 (held as phase 4 holds one rank,
     every tree gathered whole); then phi-tiny-moe at full width (its row
     and depth cut to fit four ranks on one card, its depth then for the
     run's time, the cuts printed), each
     rank drawing its shard of the seed's weights, one step of the global
     batch timed and profiled on every rank at once; per rank the step
     walls, global tokens/s, peak memory, the collectives' calls, host ms
     and share of the wall, K4's and K7's launches a step (asserted), the
     whole leaves equal across ranks after each step, the device-busy ms
     of the profiled step; a checkpoint of the ranks' shards at one
     layer saved (gathered in pieces, rank 0 writing, no rank's device
     growing by half the whole tree) and restored re-sharded bit for bit;
     step 0's loss and grad_norm held against the unsharded ``train_step``
     of the same weights and rows after the ranks end;
 16. the recurrent families on the same four ranks, their recurrent
     layers split by heads and zamba2-7b's shared block tensor-parallel:
     zamba2-7b at 21 layers and xlstm-1.3b at 24 in f32
     (``RECURRENT_DECODE_LAYERS``, ``RECURRENT_DECODE_DTYPE``) decode 8
     steps sharded (each rank its rows and heads of the recurrent states,
     zamba2's KV slots over both axes, K1
     at its KV layers) against 8 unsharded steps, from the states and
     KV of each row's own prefill: the rank's rows' logits, states and
     appended KV held, the tokens whole; zamba2-7b at 15 layers prefills
     4 x 1,024 tokens from its FSDP shards, tensor-parallel, against the
     unsharded prefill of the same rows (K4 2 launches); zamba2-7b at 8
     layers (2 x 4,096
     tokens) and xlstm-1.3b at 8 (2 x 256) trained one step, timed and
     profiled at once (the cuts printed), step 0 held against the unsharded
     ``loss_fn``; the dry run of these steps counted on the host
     meanwhile;
 17. the dry run of the steps just measured (``launch.specs``,
     ``launch.op_analysis``: the same steps on ``meta`` tensors, nothing
     allocated, no kernel launched): each kernel's launches a step equal
     to the counters' in the two training paths and yi-6b's decode step
     (K1 32 fetch, 64 in place), the collectives a step of the sharded
     rank's program (rank 0 in a fake world of four) equal to every
     rank's every step, each predicted peak within ``DRYRUN_PEAK_REL`` of
     the measured one, the three roofline terms of the H100 model printed
     beside each step's wall and device-busy ms, and the recurrent
     families' steps (launches and collectives exact, training and
     prefill peaks within ``DRYRUN_PEAK_REL``); one JSON line of them;
then the card's name and power limit, one JSON line of per-kernel
numbers (``launches_by_path`` over the served paths, the two in-place
steps, each rank of the sharded cases, musicgen-medium, the two
training paths, each rank of the sharded training path and of the
recurrent families' decode, prefill and training), and the JSON
result line.  Each phase prints its
seconds.  The launch counts are set to 0 just before each path and read
just after it.  It imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.bridge import (  # noqa: E402
    gather_train, shard_decode, shard_train)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HarvestRuntime, collectives  # noqa: E402
from repro_torch.core import paged_attention as tpa  # noqa: E402
from repro_torch.core.tiers import Fidelity, kv_block_bytes  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus, make_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.harvest_copy import ops as hops  # noqa: E402
from repro_torch.kernels.moe_ffn import ops as mops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.dryrun import roofline as dry_roofline  # noqa: E402
from repro_torch.launch.mesh import Mesh, launch, make_rules  # noqa: E402
from repro_torch.launch.op_analysis import (  # noqa: E402
    _warm_lazy_imports, count as op_count)
from repro_torch.launch.specs import build_step  # noqa: E402
from repro_torch.models import layers as LAYERS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    batch_rows, kv_block_axes, shard_slices)
from repro_torch.serving import TenantSpec, Workload  # noqa: E402
from repro_torch.train.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from repro_torch.train.loop import cosine_lr  # noqa: E402
from repro_torch.train.optim import (  # noqa: E402
    AdamWState, _global_norm, _sharded_norm, _spec_leaves, _sync_grads,
    adamw_init, train_step, tree_leaves, tree_unflatten)

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
MIXTRAL, PHI35, PHI_TINY = "mixtral-8x7b", "phi-3.5-moe", "phi-tiny-moe"
#: the depths that fit one card: 16 of mixtral-8x7b's 32 layers (23.48 B
#: parameters, 43.74 GiB in bf16; the whole model 86.99 GiB) and 16 of
#: phi-3.5-moe's 32 (21.07 B, 39.24 GiB; whole 77.99 GiB, no room left
#: for the engine beside it); phi-tiny-moe whole (3.81 B, 7.10 GiB)
MIXTRAL_LAYERS, PHI35_LAYERS = 16, 16
MUSICGEN = "musicgen-medium"
#: musicgen-medium's audio prompts: 5, 10, 20 and 30 s at EnCodec's 50 Hz
#: frame rate (MusicGen generates up to 30 s), each behind its 64
#: conditioning embeddings; the decode steps of each mode
MUSICGEN_FRAMES, MUSICGEN_STEPS = (250, 500, 1000, 1500), 64
#: largest |in-place decode logit - full-sequence forward logit| of
#: full-width musicgen-medium, bf16, 48 layers: the forward reads bf16 k
#: and v through K4 (its probabilities rounded to bf16), the decode f32
#: pools through K1, and the two residual streams part by bf16 steps over
#: the layers; 8 bf16 steps of a logit in [2, 4) (measured on an H100:
#: 0.0586-0.0625)
AUDIO_FORWARD_TOL = 2.0 ** -3
#: largest |in-place - fetch| logit of one full-width bf16 decode step:
#: the two pools' partials sum in another order than one pool's, which
#: moves the attention output by f32 ulps and, where one rounds to bf16
#: otherwise, the residual stream by a bf16 step, carried through the
#: layers; 8 bf16 steps of a logit in [4, 8) (measured on an H100:
#: 0.109-0.141 at yi-6b, 0.086-0.135 at h2o-danube-3-4b, 0.047-0.059 at
#: musicgen-medium)
INPLACE_LOGIT_TOL = 0.25
#: the kernels of one K1 call in a trace: the live-slot bitmap's pre-pass
#: (tables past 1,024 slots), the split partials, the merge of the splits
K1_KERNELS = ("live_bits_kernel", "paged_split_kernel",
              "merge_splits_kernel")
#: the least size of a timing pool that calls cycle through: past the
#: card's 50 MB L2, so that each call finds its rows cold
POOL_BYTES = 64 * 2 ** 20


def phase_done(name: str, t0: float) -> float:
    """Print the seconds a phase took since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s")
    return now


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


#: how long ``trace_rows`` goes on taking again a trace that came back
#: without a device row, where its caller asks it to, and the most idle
#: padding it gives the window.  One H100 run of this script lost five
#: single-call traces of K2 in a row, the padding doubled from 25 ms to
#: 400 ms, and another three; 300 such traces taken right after K1's and
#: K2's checks lost none (tools/probe_trace_streak.py).  So a retake waits
#: the loss out: it doubles the padding up to the cap, records CPU activity
#: on every other attempt and takes eight times the calls from the fifth on
TRACE_RETAKE_S = 90.0
TRACE_PAD_MAX_S = 3.2


def profiled(fn, iters, pad_s=TRACE_PAD_S, cpu=False):
    """The profiler (CUDA activity, and CPU activity where ``cpu``) after
    ``iters`` calls of ``fn``, the card idle for ``pad_s`` before and after
    them in its window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # one profiling cycle is all
        with profile(activities=acts) as prof:
            time.sleep(pad_s)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
    return prof


def trace_rows(fn, iters, pad_s=TRACE_PAD_S, retake_s=0.0, want=None):
    """[(name, device ms per call)] of every kernel, memset and copy that
    ``iters`` calls of ``fn`` put on the card, from the profiler's trace,
    largest first.  Where ``retake_s`` is given, a trace without a device
    row, or without what ``want(rows)`` asks for where given (a row the
    trace lost at its window's edge: one H100 run lost the first of K7's
    four backward kernels from a single call's trace), is taken again
    (``TRACE_RETAKE_S``'s note says how) until one has it or ``retake_s``
    seconds have passed, and then it raises; each retake is named on
    stderr."""
    t0 = time.perf_counter()
    attempt, calls, cpu = 0, iters, False
    while True:
        prof = profiled(fn, calls, pad_s, cpu)
        rows = device_rows(prof, calls)
        if not retake_s or (any(t > 0 for _, t in rows)
                            and (want is None or want(rows))):
            return rows
        launches = sum(e.count for e in prof.key_averages()
                       if "Launch" in e.key) if cpu else None
        attempt += 1
        waited = time.perf_counter() - t0
        what = "a device row" if not any(t > 0 for _, t in rows) else \
            f"the rows asked for (it holds {[n[:40] for n, _ in rows]})"
        print(f"  a trace came back without {what} ({calls} calls, "
              f"{pad_s * 1e3:.0f} ms padding, CPU activity {cpu}: "
              f"{launches} launch calls recorded; {waited:.1f} s since the "
              f"first): taken again", file=sys.stderr)
        if waited > retake_s:
            raise RuntimeError(f"{attempt} traces in {waited:.1f} s showed "
                               f"no device row or not the rows asked for")
        pad_s = min(2 * pad_s, TRACE_PAD_MAX_S)
        cpu = attempt % 2 == 1
        calls = iters * (8 if attempt >= 4 else 1)


def holds(check, *args):
    """``check(rows, *args)``, an asserting check of a trace's rows, as a
    predicate for ``trace_rows``' ``want``."""
    def want(rows):
        try:
            check(rows, *args)
        except AssertionError:
            return False
        return True
    return want


def wall_and_rows(fn, iters=5, warmup=3):
    """(host wall ms per call, ``trace_rows`` per call) of ``fn``: after
    ``warmup`` calls, ``iters`` calls back to back between two
    synchronisations, then a trace of ``iters`` more."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / iters,
            trace_rows(fn, iters, retake_s=TRACE_RETAKE_S))


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


def cost_bound(cost):
    """``bound`` of a kernel's cost function's numbers (its wrapper's
    ``*_cost`` in ``repro_torch.kernels``), at the peak rate of the dtype
    it computes in: bf16 on the tensor cores, f32 on the CUDA cores."""
    peak = BF16_FLOPS if cost.dtype in (torch.bfloat16, torch.float16) \
        else F32_FLOPS
    return bound(cost.nbytes, cost.flops, peak)


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
    """The least time of one K1 call over f32 pools with rows at ``q_pos``
    (``paged_decode_partials_cost``; the slot size enters only where the
    positions are not given)."""
    return cost_bound(pops.paged_decode_partials_cost(
        len(q_pos), nq, nkv, hd, n_slots, 0, q_pos=q_pos,
        sliding_window=window, attention_chunk=chunk))


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


def deal_pools(L, q_pos, bs, nkv, hd, peer_of, seed, steps=1,
               device="cuda", fill=None, slots=None, peer_slots=None):
    """Each row's blocks (those its positions up to ``q_pos[r] + steps -
    1`` need) dealt in shuffled order over a fetch pool of ``bs``-token
    slots, (L, n, bs, nkv, hd) f32 of random values that ``fill(pk, pv,
    where)`` may overwrite; the in-place layout then moves the blocks
    ``peer_of(r, j)`` names to a peer pool of their own, in shuffled
    slots, and frees them in a copy of the fetch pool (the local pool),
    leaving garbage behind.  Each pool keeps 8 free slots of garbage, or
    holds ``slots`` (the fetch and local pools) and ``peer_slots`` slots.
    Returns the fetch, local and peer ``KVPools`` (the append fields each
    row's slot and offset at ``q_pos``) and {(row, block): fetch slot}."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    blocks = [(r, j) for r, p in enumerate(q_pos)
              for j in range((p + steps - 1) // bs + 1)]
    moved = [rj for rj in blocks if peer_of(*rj)]

    def pool(owned, n=None):
        n = n or len(owned) + 8
        assert n >= len(owned), (n, len(owned))
        kv = [torch.randn((L, n, bs, nkv, hd), generator=gen, device=device)
              for _ in range(2)]
        sr = np.full((n,), -1, np.int32)
        sb = rng.integers(0, 512, size=n).astype(np.int32)
        where = dict(zip(owned, rng.permutation(n).tolist()))
        for (r, j), slot in where.items():
            sr[slot], sb[slot] = r, j * bs
        return kv + [sr, sb], where

    fetch, where = pool(blocks, slots)
    if fill is not None:
        fill(fetch[0], fetch[1], where)
    peer, at = pool(moved, peer_slots)
    src = [where[rj] for rj in moved]
    dst = [at[rj] for rj in moved]
    local = [fetch[0].clone(), fetch[1].clone(), fetch[2].copy(), fetch[3]]
    local[2][src] = -1
    for a in range(2):
        peer[a][:, dst] = fetch[a][:, src]
        local[a][:, src] = torch.randn(local[a][:, src].shape, generator=gen,
                                       device=device)
    cast = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731,E501
    aslot = cast([where[(r, p // bs)] for r, p in enumerate(q_pos)])
    aoff = cast(np.asarray(q_pos) % bs)
    return tuple(M.KVPools(p[0], p[1], cast(p[2]), cast(p[3]), aslot, aoff)
                 for p in (fetch, local, peer)) + (where,)


def time_two_pool_k1(cfg, bs, q_pos):
    """K1 as the in-place mode calls it at ``cfg``'s decode shape: once
    over the local pool and once over the peer pool holding the first half
    of each row's blocks (row 1 none), the two calls' partials merged by
    log-sum-exp and normalised (``paged_decode_attention``).  Held to the
    same over the plain version and to one call over the fetch pool that
    holds every block; row 1's peer partials must be empty (m -1e30, l 0,
    acc 0) and its merged result its local result bit for bit.  Timed
    beside the plain version and the fetch call; the bound counts each
    row's positions once, over both pools."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    fetch, local, peer, _ = deal_pools(
        1, q_pos, bs, nkv, hd,
        lambda r, j: r != 1 and j < (q_pos[r] // bs + 1) // 2, SEED + 11)
    fetch, local, peer = ((kv.pool_k[0], kv.pool_v[0], kv.slot_req,
                           kv.slot_base) for kv in (fetch, local, peer))
    q = torch.randn((len(q_pos), nq, hd), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 11))
    qp = torch.tensor(q_pos, dtype=torch.int32, device="cuda")

    def plain(pools):
        parts = [pops.paged_decode_partials_plain(
            q, *p, qp, scale=hd ** -0.5) for p in pools]
        return tpa.finalize(tpa.merge_partials(parts))

    before = pops.paged_decode_partials.launches
    got = tpa.paged_decode_attention(q, [local, peer], qp, cfg)
    torch.cuda.synchronize()
    assert pops.paged_decode_partials.launches == before + 2
    ref = plain([local, peer])
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    err = _max_err(got, ref)
    one = tpa.paged_decode_attention(q, [fetch], qp, cfg)
    torch.testing.assert_close(got, one, rtol=1e-4, atol=1e-4)
    empty = tpa.pool_partials(q, *peer, qp, cfg)
    assert torch.all(empty.m[1] == -1e30) and torch.all(empty.l[1] == 0) \
        and torch.all(empty.acc[1] == 0)
    assert torch.equal(got[1], tpa.paged_decode_attention(
        q, [local], qp, cfg)[1])
    ms, ms_wall = time_ms(lambda: tpa.paged_decode_attention(
        q, [local, peer], qp, cfg), 100)
    plain_ms, _ = time_ms(lambda: plain([local, peer]), 10)
    fetch_ms, _ = time_ms(lambda: tpa.paged_decode_attention(
        q, [fetch], qp, cfg), 100)
    n_slots = local[2].shape[0] + peer[2].shape[0]
    bound_ms, bound_by = k1_bound(q_pos, n_slots, nq, nkv, hd)
    on_peer = int((peer[2] >= 0).sum())
    print(f"  paged_decode_partials over a local and a peer pool, merged, at "
          f"{cfg.name} ({nq}/{nkv} heads, gq {nq // nkv}, hd {hd}), rows at "
          f"{list(q_pos)}, {on_peer} of {int((fetch[2] >= 0).sum())} blocks "
          f"of {bs} on the peer (row 1 none): {ms:.5f} ms device (two K1 "
          f"calls and the merge), {ms_wall:.5f} between events; one call "
          f"over the fetch pool {fetch_ms:.5f}; plain {plain_ms:.5f}; bound "
          f"{bound_ms:.6f} ({bound_by}); max_abs_err {err:.3g}")
    return dict(shape=f"{cfg.name} local + peer pools merged, rows "
                f"{list(q_pos)}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                gq=nq // nkv, fetch_ms=fetch_ms, launches_per_call=2,
                blocks_on_peer=on_peer)


def block_elems(cfg, bs) -> int:
    """f32 elements of one demoted block: a row of L_kv * 2 * bs * nkv * hd,
    as the engine's _degrade passes it."""
    return (M.num_kv_layers(cfg) * 2 * bs * cfg.num_kv_heads
            * cfg.resolved_head_dim)


#: runtime calls the profiler may hang the next kernel's time on: no row of
#: a trace may carry their names
RUNTIME_CALLS = ("cudaFuncSetAttribute", "cudaLaunchKernelEx")


def traced_rows(fn, iters):
    """``trace_rows`` of ``iters`` calls of ``fn``, a trace without a device
    row taken again; its rows with device time, none of them named after a
    runtime call."""
    rows = [(n, t) for n, t in trace_rows(fn, iters,
                                          retake_s=TRACE_RETAKE_S) if t > 0]
    assert not any(c in n for n, _ in rows for c in RUNTIME_CALLS), rows
    return rows


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
        for fn_k, fn_p, cost, name in (
            (quant, lambda: hops.quantize_blocks_plain(pool, ids()[0],
                                                       "int8"),
             hops.quantize_blocks_cost(1, elems, elems, 4),
             "quantize_demote"),
            (dequant, lambda: hops.dequantize_blocks_plain(dst, vals, scales,
                                                  ids()[0], "int8"),
             hops.dequantize_blocks_cost(1, elems, elems, 4),
             "dequantize_reload"),
        ):
            (ms, ms_wall), (plain_ms, _) = time_ms(fn_k, 200), \
                time_ms(fn_p, 50)
            bound_ms, bound_by = cost_bound(cost)
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
        # library call, it with device ids, it with host ids, cost): the
        # kernels and the plain versions take host ids, as the engine's
        # evict and reload pass them
        cases = (
            ("gather_blocks", 68, "gather_rows_kernel",
             lambda: hops.gather_blocks(pool, layer_rows + slot(), out=half),
             lambda: hops.gather_blocks_plain(pool, layer_rows + slot()),
             "index_select",
             lambda: torch.index_select(pool, 0, dev_ids[slot()]),
             lambda: torch.index_select(pool, 0, host(layer_rows + slot())),
             hops.gather_blocks_cost(L, row_bytes)),
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
             hops.copy_blocks_cost(L, row_bytes)),
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
        for name, line, kname, fn_k, fn_p, lib, fn_dev, fn_host, cost \
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
            bound_ms, bound_by = cost_bound(cost)
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
        bound_ms, bound_by = cost_bound(mops.moe_ffn_cost(
            e, xd.shape[1], d, f, 2, rows=rows, experts=used))
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
    bound_ms, bound_by = cost_bound(mops.moe_ffn_cost(
        e, xd.shape[1], d, f, 2, rows=tokens, experts=filled))
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


#: K7's backward against its plain version: each gradient within this
#: share of the output's largest entry.  bf16: the kernels and cuBLAS sum
#: in other orders, so dA, dH or dG may round one bf16 step apart, and the
#: gradients that read them move by a step of their own magnitude; f32:
#: sums over C, d and f in other orders.
MOE_BWD_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def hold_moe_bwd(got, ref, dtype):
    """Holds K7's gradients (dxd, dwi, dwg, dwo) to the plain backward's
    within ``MOE_BWD_REL``; returns each one's largest |difference|."""
    errs = []
    for name, g, r in zip(("dxd", "dwi", "dwg", "dwo"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        err, scale = _max_err(g, r), r.float().abs().max().item()
        assert err <= MOE_BWD_REL[dtype] * scale, (name, err, scale)
        errs.append(err)
    return errs


_LIB_ACT = {"silu": torch.nn.functional.silu,
            "gelu": lambda u: torch.nn.functional.gelu(u, approximate="tanh"),
            "relu2": lambda u: torch.relu(u).square()}


def library_moe(xd, w, activation):
    """The bmm composition of the expert FFN (bmm, act, bmm, bmm)."""
    act = _LIB_ACT[activation]
    return torch.bmm(act(torch.bmm(xd, w[1])) * torch.bmm(xd, w[0]), w[2])


def moe_train_fwd_case(label, xd, w, activation, time=True):
    """K7's bf16 training forward (``moe_ffn_train``) at one shape: held to
    ``moe_ffn_plain(..., residuals=True)`` (the output, and A, h and g
    with their pad columns zero, within ``MOE_TOL``), its 128-row C tiles
    without a token skipped (counted on the card), a second call the same
    bits; then (``time``) timed beside the plain version, the bmm
    composition and the bound (6 flops a dispatched row per (d, f) pair;
    xd and the output, the weights of the experts holding a token and
    the A, h and g it writes).  Returns (its row, what it saved)."""
    e, c, d = xd.shape
    f = w[0].shape[-1]
    empty = (xd == 0).all(-1)
    rows, filled = int((~empty).sum()), int((~empty).any(1).sum())
    t = mops.TRAIN_TILE
    tiles = int(sum(bool(empty[x, r:r + t].all())
                    for x in range(e) for r in range(0, c, t)))
    skipped = torch.zeros((1,), dtype=torch.int32, device="cuda")
    out, saved = mops.moe_ffn_train(xd, *w, activation=activation,
                                    skipped=skipped)
    ref, res = mops.moe_ffn_plain(xd, *w, activation, residuals=True)
    torch.testing.assert_close(out.float(), ref.float(),
                               **MOE_TOL[torch.bfloat16])
    err = _max_err(out, ref)
    for got, r in zip(saved[4:7], res):
        torch.testing.assert_close(got[..., :f].float(), r.float(),
                                   **MOE_TOL[torch.bfloat16])
        assert bool((got[..., f:] == 0).all())
    assert bool((out[empty] == 0).all())
    assert int(skipped.item()) == tiles, (label, skipped, tiles)
    again, saved2 = mops.moe_ffn_train(xd, *w, activation=activation)
    assert torch.equal(out, again) and all(
        torch.equal(a, b) for a, b in zip(saved, saved2)), label
    del ref, res, again, saved2
    row = dict(shape=label, activation=activation, E=e, C=c, d=d, f=f,
               rows=rows, experts_with_token=filled, tiles_skipped=tiles,
               max_abs_err=err)
    line = (f"  moe_ffn_train {label} (E {e}, C {c}, d {d}, f {f}, "
            f"{activation}; {rows} dispatched rows, {tiles} 128-row tiles "
            f"skipped): max_abs_err {err:.3g} (A, h, g held too, their pad "
            f"columns zero), a second call bit-identical")
    if time:
        ms, _ = time_ms(lambda: mops.moe_ffn_train(xd, *w,
                                                   activation=activation),
                        5, warmup=2)
        plain_ms, _ = time_ms(lambda: mops.moe_ffn_plain(xd, *w, activation),
                              3, warmup=1)
        library_ms, _ = time_ms(lambda: library_moe(xd, w, activation), 5,
                                warmup=2)
        bound_ms, bound_by = cost_bound(mops.moe_ffn_train_cost(
            e, c, d, f, 2, rows=rows, experts=filled))
        traced = [(n, ms_) for n, ms_ in trace_rows(
            lambda: mops.moe_ffn_train(xd, *w, activation=activation), 1)]
        row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   kernels_ms={n[:60]: t_ for n, t_ in traced})
        line += (f"; {ms:.4f} ms device ("
                 + ", ".join(f"{n.split('<')[0].split('::')[-1][:40]} "
                             f"{t_:.4f}" for n, t_ in traced)
                 + f"); plain {plain_ms:.4f}; library (bmm, {activation}, "
                 f"bmm, bmm) {library_ms:.4f}; bound {bound_ms:.4f} "
                 f"({bound_by}, {6 * rows * d * f / 1e9:.1f} GFLOP)")
    print(line)
    return row, saved


def moe_bwd_case(label, xd, w, dout, activation, time=True):
    """K7's backward at one shape: held to the plain backward, a bf16 call
    repeated bit for bit, each tokenless expert's weight gradients exact
    zeros, the C tiles without a token skipped (128 rows in bf16, 64 in
    f32; counted on the card), the kernels that ran read from a trace; in
    bf16 the training forward first held by ``moe_train_fwd_case``; then
    (``time``) timed beside the plain backward, the bmm composition's
    backward (``torch.autograd.grad`` of one forward, the graph kept) and
    the bound: in bf16 the backward alone on the training forward's saved
    A, h and g (``moe_ffn_bwd_saved``, what a training step runs), in f32
    ``moe_ffn_bwd``.  Returns (its row, the training forward's row or
    None)."""
    dtype = xd.dtype
    e, c, d = xd.shape
    f = w[0].shape[-1]
    bf16 = dtype == torch.bfloat16
    fwd_row, saved = moe_train_fwd_case(label, xd, w, activation, time) \
        if bf16 else (None, None)
    empty = (xd == 0).all(-1)
    rows = int((~empty).sum())
    tokenless = [x for x in range(e) if bool(empty[x].all())]
    filled = e - len(tokenless)
    t = mops.bwd_tile(dtype)
    tiles = int(sum(bool(empty[x, r:r + t].all())
                    for x in range(e) for r in range(0, c, t)))
    skipped = torch.zeros((1,), dtype=torch.int32, device="cuda")
    got = mops.moe_ffn_bwd(xd, *w, dout, activation=activation,
                           skipped=skipped)
    if bf16:
        again = mops.moe_ffn_bwd_saved(saved, dout, activation=activation)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), label
        del again
    assert int(skipped.item()) == tiles, (label, skipped, tiles)
    for g in got[1:]:
        assert all(bool((g[x] == 0).all()) for x in tokenless), label
    ref = mops.moe_ffn_bwd_plain(xd, *w, dout, activation)
    errs = hold_moe_bwd(got, ref, dtype)
    del got, ref

    def bwd():
        if bf16:
            return mops.moe_ffn_bwd_saved(saved, dout, activation=activation)
        return mops.moe_ffn_bwd(xd, *w, dout, activation=activation)

    traced = assert_moe_bwd_kernels(
        trace_rows(bwd, 1, retake_s=TRACE_RETAKE_S,
                   want=holds(assert_moe_bwd_kernels, dtype)), dtype)
    row = dict(shape=label, dtype=str(dtype)[6:], activation=activation,
               E=e, C=c, d=d, f=f, rows=rows, experts_with_token=filled,
               tiles_skipped=tiles, max_abs_err=max(errs))
    line = (f"  moe_ffn_bwd {label} (E {e}, C {c}, d {d}, f {f}, "
            f"{str(dtype)[6:]}, {activation}; {rows} dispatched rows, "
            f"{filled} experts hold a token, {tiles} {t}-row tiles skipped): "
            f"max_abs_err dxd {errs[0]:.3g}, dwi {errs[1]:.3g}, dwg "
            f"{errs[2]:.3g}, dwo {errs[3]:.3g} (within "
            f"{MOE_BWD_REL[dtype]:.3g} of each one's largest)"
            + (", the backward on the saved forward bit-identical to "
               "moe_ffn_bwd's" if bf16 else ""))
    if time:
        ms, _ = time_ms(bwd, 5, warmup=2)
        plain_ms, _ = time_ms(lambda: mops.moe_ffn_bwd_plain(
            xd, *w, dout, activation), 3, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (xd, *w)]
        out = library_moe(leaves[0], leaves[1:], activation)
        library_ms, _ = time_ms(lambda: torch.autograd.grad(
            out, leaves, dout, retain_graph=True), 3, warmup=1)
        del out, leaves
        # in bf16 the backward reads the training forward's A, h and g
        bound_ms, bound_by = cost_bound(mops.moe_ffn_bwd_cost(
            e, c, d, f, xd.element_size(), saved=bf16, rows=rows,
            experts=filled))
        row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   kernels_ms={n[:60]: t for n, t in traced})
        line += (f"; {ms:.4f} ms device ("
                 + ", ".join(f"{n.split('<')[0].split('::')[-1]} {t:.4f}"
                             for n, t in traced)
                 + f"); plain {plain_ms:.4f}; library (autograd of bmm, "
                 f"{activation}, bmm, bmm) {library_ms:.4f}; bound "
                 f"{bound_ms:.4f} ({bound_by}, "
                 f"{12 * rows * d * f / 1e9:.1f} GFLOP)")
    print(line)
    return row, fwd_row


#: tensor parallelism's row-parallel products at zamba2-7b's prefill
#: shape on one of two ``model`` ranks (2 x 1,024 rows): case -> (rows,
#: the rank's share of the contraction, out)
ROW_PARALLEL_CASES = {"attention out": (2048, 16 * 112, 3584),
                      "MLP down": (2048, 7168, 3584)}


def check_row_parallel():
    """``layers.row_parallel`` on the card (bf16 operands, an f32
    output: ``torch.mm(..., out_dtype=)`` and its backward in bf16)
    against the operands widened, as the CPU computes it: the output
    within 1e-5 of its largest entry (f32 sums in another order), each
    operand's gradient within one bf16 step of its largest entry (a
    bf16-valued upstream gradient, each rounded once); both timed,
    forward and forward with backward, beside the unsplit bf16 product.
    Returns the numbers; raises if a reading is off."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    out = {}
    for case, (m, k, n) in ROW_PARALLEL_CASES.items():
        a = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16).requires_grad_(True)
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16).requires_grad_(True)
        g = torch.randn((m, n), generator=gen, device="cuda").to(
            torch.bfloat16).float()

        def card():
            return LAYERS.row_parallel(a, w, 1)

        def widened():
            return a.float() @ w.float()

        def both(fn):
            y = fn()
            return (y, *torch.autograd.grad(y, (a, w), g))

        got, want = both(card), both(widened)
        errs = [_rel(x.float(), y.float()) for x, y in zip(got, want)]
        assert got[0].dtype == torch.float32, got[0].dtype
        assert errs[0] <= 1e-5 and max(errs[1:]) <= 2.0 ** -7, (case, errs)
        with torch.no_grad():
            ms = dict(ms=time_ms(card, iters=20, warmup=3)[0],
                      widened_ms=time_ms(widened, iters=20, warmup=3)[0],
                      unsplit_ms=time_ms(lambda: torch.cat(
                          [a, a], 1) @ torch.cat([w, w], 0), iters=20,
                          warmup=3)[0])
        ms["with_backward_ms"] = time_ms(lambda: both(card), iters=10,
                                         warmup=2)[0]
        ms["widened_with_backward_ms"] = time_ms(lambda: both(widened),
                                                 iters=10, warmup=2)[0]
        out[case] = dict(shape=[m, k, n], rel_errs=errs, **ms)
        print(f"row-parallel product, {case} ({m} x {k} x {n}, bf16, f32 "
              f"out): output, dA, dW apart from the widened product by "
              f"{[f'{e:.2e}' for e in errs]} of each largest entry "
              f"(tolerance 1e-5, 2^-7); {ms['ms']:.4f} ms (widened "
              f"{ms['widened_ms']:.4f}, the unsplit bf16 product of twice "
              f"the contraction {ms['unsplit_ms']:.4f}); with its backward "
              f"{ms['with_backward_ms']:.4f} ms (widened "
              f"{ms['widened_with_backward_ms']:.4f})")
        del a, w, g, got, want
    return out


def check_moe_ffn_bwd(phi, qwen, dbrx):
    """K7's training kernels against their plain versions on the card:
    phi-tiny-moe's training shape (8,192 tokens routed top-2 over 16
    experts by a random router, C 1,280, one expert forced tokenless), a
    rank's shape on the sharded training path (``SHARDED_SEQ`` tokens
    routed over the 16, C 640, the 8 experts of one ``model`` index kept;
    untimed), qwen2-moe's width (64 experts, f 1,408, 512 tokens routed top-4),
    DBRX's f 10,752 at C 5 (16 tokens routed top-4), all bf16 and silu,
    the training forward and the backward each timed (no target at the
    last two); an odd d 37 and f 77 in f32 and bf16 under silu, gelu and
    relu2.  The cotangent is zero on every empty slot, as the combine
    leaves it.  Then a whole MoE layer's gradient at phi-tiny-moe's width
    taken twice on the card: the training forward's and the backward's
    kernels, the dispatch gather's and the combine's backward repeat bit
    for bit.  Returns (the backward's kernel entry, the training
    forward's)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rows, fwd_rows = [], []

    def routed(cfg, t, tokenless=(), held=None):
        mc = cfg.moe
        xd = dispatch_buffer(cfg, t, gen)[0]
        xd[list(tokenless)] = 0
        if held is not None:        # the experts one rank holds
            xd = xd[held].contiguous()
        w = expert_weights(xd.shape[0], cfg.d_model, mc.d_ff_expert,
                           torch.bfloat16, gen)
        dout = torch.randn(xd.shape, generator=gen, device="cuda").bfloat16()
        dout[(xd == 0).all(-1)] = 0
        return xd, w, dout

    def case(*args, **kw):
        row, fwd_row = moe_bwd_case(*args, **kw)
        rows.append(row)
        if fwd_row is not None:
            fwd_rows.append(fwd_row)

    half = phi.moe.num_experts // TRAIN_MESH[0][1]
    for label, cfg, t, tokenless, held, timed in (
            ("phi-tiny-moe training shape", phi, 8192, (0,), None, True),
            ("qwen2-moe width", qwen, 512, (), None, True),
            ("dbrx-132b width", dbrx, 16, (), None, True),
            # a rank of the sharded training path: its data shard's 4,096
            # tokens routed over all 16 experts (C 640), its 8 kept
            (f"{PHI_TINY} sharded training rank", phi, SHARDED_SEQ, (),
             slice(half, 2 * half), False)):
        xd, w, dout = routed(cfg, t, tokenless, held)
        case(label, xd, w, dout, cfg.activation, time=timed)
        del xd, w, dout
    for dtype in (torch.float32, torch.bfloat16):
        xd = torch.randn((3, 70, 37), generator=gen, device="cuda")
        xd[:, 60:], xd[1] = 0, 0
        w = [(torch.randn(s, generator=gen, device="cuda") * sc).to(dtype)
             for s, sc in (((3, 37, 77), 37 ** -0.5), ((3, 37, 77),
                                                      37 ** -0.5),
                           ((3, 77, 37), 77 ** -0.5))]
        dout = torch.randn(xd.shape, generator=gen, device="cuda")
        dout[(xd == 0).all(-1)] = 0
        for act in ("silu", "gelu", "relu2"):
            case("odd d 37 and f 77", xd.to(dtype), w, dout.to(dtype), act,
                 time=False)
    check_moe_layer_grad_repeats(phi, gen)
    torch.cuda.synchronize()
    main, fwd = rows[0], fwd_rows[0]
    bwd_entry = dict(
        name="moe_ffn_bwd", route="cuda",
        source="src/repro_torch/csrc/moe_ffn.cu",
        replaces="src/repro/models/moe.py:77",
        note="no Pallas counterpart: the JAX package differentiates "
        "moe.expert_ffn (three einsums) with XLA; this is that gradient, "
        "in bf16 read from the training forward's A, h and g",
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        library_backend="torch.autograd.grad of the bmm composition (bmm, "
        "act, bmm, bmm), the graph kept", shape=main["shape"], by_shape=rows)
    fwd_entry = dict(
        name="moe_ffn_train", route="cuda",
        source="src/repro_torch/csrc/moe_ffn.cu",
        replaces="src/repro/kernels/moe_ffn/kernel.py:53",
        note="K7's forward on the training path (bf16 under grad): 128-row "
        "tiles on wgmma, writing A, h and g for the backward; calls "
        "without a gradient keep moe_ffn's decode kernels",
        max_abs_err=max(r["max_abs_err"] for r in fwd_rows), ms=fwd["ms"],
        plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
        bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
        library_backend="the bmm composition (bmm, act, bmm, bmm)",
        shape=fwd["shape"], by_shape=fwd_rows)
    return bwd_entry, fwd_entry


def check_moe_layer_grad_repeats(cfg, gen):
    """One MoE layer at ``cfg``'s width over 8,192 bf16 tokens: the
    gradient of ``sum(y * ct) + aux`` with respect to x and the layer's
    weights, taken twice on the card, is the same bits both times (the
    dispatch gather's backward accumulates each token's top-k rows, the
    combine's its slots); the device kernels of the backward that index,
    scatter or sort are printed by name."""
    mc, d = cfg.moe, cfg.d_model
    p = {"router": torch.randn((d, mc.num_experts), generator=gen,
                               device="cuda") * 0.02}
    p.update(zip(("wi", "wg", "wo"), expert_weights(
        mc.num_experts, d, mc.d_ff_expert, torch.bfloat16, gen)))
    x = torch.randn((1, 8192, d), generator=gen, device="cuda").bfloat16()
    ct = torch.randn(x.shape, generator=gen, device="cuda")
    leaves = [x, *p.values()]

    def grads():
        ls = [t.detach().requires_grad_() for t in leaves]
        y, probs, ids = MOE.moe_layer(ls[0], dict(zip(p, ls[1:])), cfg)
        loss = torch.sum(y.float() * ct) \
            + MOE.load_balance_loss(probs, ids, mc.num_experts)
        return torch.autograd.grad(loss, ls)

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    rows = trace_rows(grads, 1)
    names = sorted({n.removeprefix("void ").split("<")[0] for n, _ in rows
                    if any(k in n.lower() for k in ("index", "scatter",
                                                    "sort", "put"))})
    print(f"  moe_layer at {cfg.name}'s width, 8192 tokens: its gradient "
          f"(x, router, wi, wg, wo) taken twice, bit-identical; indexing "
          f"kernels of the pass and backward: {names}")


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
            bound_ms, bound_by = cost_bound(fops.prefill_attention_cost(
                q.shape[0], n, n, nq, nkv, hd, q.element_size(), pairs=pairs))
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


def check_flash_bwd(danube, yi, llama4, zamba2, phi):
    """K4's backward against its plain version on the card, on the same o,
    LSE and dO: at danube's training sequence (8,192 tokens, twice its
    window), yi-6b's heads at 2,048 tokens, Llama-4's heads across its
    8,192-token chunk, zamba2-7b's MHA at hd 112, phi-tiny-moe's heads
    over a sharded training rank's row (``SHARDED_SEQ`` tokens), and a
    small f32 case.
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
              (f"{PHI_TINY} heads over a sharded training rank's row", phi,
               SHARDED_SEQ, torch.bfloat16, {}),
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
                                               **masks), 1,
            retake_s=TRACE_RETAKE_S, want=holds(assert_bwd_kernels, dtype)),
            dtype)
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
            fwd_cost = fops.prefill_attention_cost(
                q.shape[0], n, n, nq, nkv, hd, q.element_size(), pairs=pairs,
                lse=True)
            bwd_cost = fops.prefill_attention_bwd_cost(
                q.shape[0], n, n, nq, nkv, hd, q.element_size(), pairs=pairs)
            fwd_flops, bwd_flops = fwd_cost.flops, bwd_cost.flops
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
            fb, fb_by = cost_bound(fwd_cost)
            bb, bb_by = cost_bound(bwd_cost)
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


def _train_steps(params, batches, cfg, lr, device, opt=None, rules=None):
    """``train_step`` over ``batches`` on ``device`` from a copy of
    ``params`` and of the AdamW state ``opt`` (a fresh one if None):
    ([metrics per step], the parameters' leaves after the last step,
    [(mu's leaves, nu's leaves) after each step], (the parameters, the
    AdamW state) after the last step), all on the CPU.  ``rules``: a rank
    of a mesh; it trains its shard (``bridge.shard_train``) and every tree
    returned is gathered whole on every rank (``bridge.gather_train``,
    collective)."""
    p = _map(params, lambda t: t.clone().to(device))
    opt = None if opt is None else AdamWState(
        opt.step.to(device, copy=True),
        *(_map(m, lambda t: t.to(device, copy=True))
          for m in (opt.mu, opt.nu)))
    if rules is not None:
        p, opt = shard_train(p, opt, cfg, rules)
    opt = adamw_init(p) if opt is None else opt

    def whole(p, opt):
        return (p, opt) if rules is None else \
            gather_train(p, opt, cfg, rules, dst=None)

    hist, moments = [], []
    for b in batches:
        p, opt, m = train_step(p, opt, {k: torch.from_numpy(v).to(device)
                                        for k, v in b.items()}, cfg, rules,
                               lr=lr)
        hist.append({k: float(v) for k, v in m.items()})
        # copies: the update works in place, and .cpu() of a CPU tensor is
        # the tensor itself
        o = whole(p, opt)[1]
        moments.append(([t.to("cpu", copy=True) for t in tree_leaves(o.mu)],
                        [t.to("cpu", copy=True) for t in tree_leaves(o.nu)]))
    p, opt = whole(p, opt)
    end = (_map(p, lambda t: t.to("cpu", copy=True)),
           AdamWState(opt.step.cpu(), *(_map(m, lambda t: t.to("cpu",
                                                               copy=True))
                                        for m in (opt.mu, opt.nu))))
    return hist, [t.to("cpu", copy=True) for t in tree_leaves(p)], moments, \
        end


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
    (h_ref, p_ref, m_ref), (h_run, p_run, m_run) = ref[:3], run[:3]
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


#: K7's backward kernels for each dtype, as the trace names them: bf16
#: on wgmma (dA with dH and dG, dX, dWi and dWg, dWo), f32 on the CUDA
#: cores (the gate pass recomputing h and g, dX, the weights)
MOE_BWD_KERNELS = {
    torch.bfloat16: ("moe_bwd_dgate_wgmma_kernel", "moe_bwd_dx_wgmma_kernel",
                     "moe_bwd_dw_wgmma_kernel", "moe_bwd_dwo_wgmma_kernel"),
    torch.float32: ("moe_bwd_gate_f32_kernel", "moe_bwd_dx_f32_kernel",
                    "moe_bwd_dw_f32_kernel")}
#: K7's forward kernels under grad: bf16's training forward, f32's decode
#: kernels; and the bf16 decode kernels, which training must not run
MOE_FWD_KERNELS = {
    torch.bfloat16: ("moe_train_flags_kernel", "moe_train_gate_wgmma_kernel",
                     "moe_train_down_wgmma_kernel"),
    torch.float32: ("gate_up_f32_kernel", "down_f32_kernel")}
MOE_DECODE_BF16 = ("gate_up_mma_kernel", "down_mma_kernel")


def assert_moe_bwd_kernels(rows, dtype):
    """K7's backward kernels in a trace's rows are ``dtype``'s, each of
    them ran, and no other (PR 25's bf16 mma.sync kernels are gone);
    returns their rows."""
    names = [n for n, _ in rows if "moe_bwd_" in n]
    want = MOE_BWD_KERNELS[dtype]
    ran = {k for k in want for n in names if k in n}
    stray = [n for n in names if not any(k in n for k in want)]
    assert ran == set(want) and not stray, (dtype, names)
    return [(n, ms) for n, ms in rows if "moe_bwd_" in n]


def assert_moe_fwd_kernels(rows, dtype):
    """K7's forward kernels under grad in a trace's rows: ``dtype``'s
    (bf16: the training forward's three), and not the bf16 decode
    kernels; returns their rows."""
    want = MOE_FWD_KERNELS[dtype]
    names = [n for n, _ in rows]
    assert all(any(k in n for n in names) for k in want), (dtype, names)
    assert not any(k in n for k in MOE_DECODE_BF16 for n in names), names
    return [(n, ms) for n, ms in rows if any(k in n for k in want)]


def expected_training_launches(cfg, steps, dtype=torch.bfloat16):
    """What a training run of ``steps`` steps launches: K4's forward twice
    an attention layer a step (the pass and the recompute) and its
    backward once, K7's the same for each MoE layer (its forward the
    training forward in bf16, the decode kernels' in f32), nothing
    else."""
    L, moe = cfg.num_layers, cfg.num_moe_layers
    fwd = "moe_ffn_train" if dtype == torch.bfloat16 else "moe_ffn"
    return dict({n: 0 for n in COUNTERS}, prefill_attention=2 * L * steps,
                prefill_attention_bwd=L * steps, moe_ffn_bwd=moe * steps,
                **{fwd: 2 * moe * steps})


class Routing:
    """Inside ``with``: records every call of the MoE router (its top-k
    ids, each row's gap log(p_k / p_(k+1)) between its k-th and (k + 1)-th
    probability, and the log-probabilities, on the CPU), or with
    ``replay`` (another run's calls) takes the ids of that run's call of
    the same index, its gate weights gathered from this run's
    probabilities, as the router's own."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        self.orig = MOE.router_topk
        MOE.router_topk = self.topk
        return self

    def __exit__(self, *exc):
        MOE.router_topk = self.orig

    def topk(self, logits, top_k):
        weights, ids, probs = self.orig(logits, top_k)
        if self.replay is not None:
            ids = self.replay[len(self.calls)][0].to(ids.device)
            weights = probs.gather(1, ids.long())
            weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                            min=1e-9)
        logp = torch.log(probs.detach())
        top = torch.sort(logp, dim=-1, descending=True).values
        self.calls.append((ids.cpu(), (top[:, top_k - 1] - top[:, top_k])
                           .cpu(), logp.cpu()))
        return weights, ids, probs


def routing_differences(cpu, card, first_step_calls):
    """[(call, row, gap)] of the rows that the card routed to other experts
    than the CPU did (the least of the two runs' gaps).  In the first
    ``first_step_calls`` calls (the first step, from the same parameters,
    so the router's inputs differ by the runs' roundings alone) each must
    be a near tie that those roundings explain: the two runs' gaps sum to
    no more than twice the row's largest difference of a log-probability
    between the runs (a swap of two experts across the k-th place moves
    their log-ratio by at most that much)."""
    assert len(cpu) == len(card), (len(cpu), len(card))
    out = []
    for i, ((ia, ga, la), (ib, gb, lb)) in enumerate(zip(cpu, card)):
        differ = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        for r in differ.nonzero().flatten().tolist():
            moved = float((la[r] - lb[r]).abs().max())
            assert i >= first_step_calls \
                or float(ga[r] + gb[r]) <= 2 * moved, \
                (i, r, float(ga[r]), float(gb[r]), moved)
            out.append((i, r, float(min(ga[r], gb[r]))))
    return out


def check_reduced_training(arch="h2o-danube-3-4b", dtype=torch.float32,
                           steps=2, batch=2, seq_len=160, lr=1e-3,
                           rules=None, **changes):
    """A reduced model (danube's: window 64, so the 160-token sequences
    cross it; ``changes`` replace fields of the reduced config) trained
    ``steps`` AdamW steps on the CPU (plain versions) and on the card (K4's
    and, for an MoE model, K7's forward and backward kernels: f32 on the
    CUDA cores, bf16 on the tensor cores) from the same weights (f32, or
    the seed's bf16) and batches, held by ``hold_training``.  An MoE model
    in bf16 is held step by step, each step's CPU reference taken from
    the card's parameters and AdamW state before it: in bf16 a router near
    tie or a gradient entry whose sign AdamW's update follows makes the two
    runs' parameters part after one step, and an MoE layer's experts,
    each fed by a few tokens, carry that into the next step's moments
    (reduced Llama-4's trajectory: its dense MLP's mu 0.0319 of the leaf's
    largest after two steps, the limit 2^-5).  A row that the card routes
    to other experts than the CPU must be a near tie that the runs'
    roundings explain (``routing_differences``; every call of a step taken
    from one state, the first step's calls of a trajectory), and the CPU's
    reference is then taken again under the card's routing.  On the card
    each kernel must launch as ``expected_training_launches`` says, and the
    profile must show the backward kernels for ``dtype`` and no other
    backward kernel.  ``rules``: this is a rank of a mesh (the sharded
    training phase): both runs train the rank's shard of the same weights
    on its rows of the same global batches (``_train_steps``), every tree
    held gathered whole; a rerun under the card's routing is taken on
    every rank where any rank needs one (its collectives must match); no
    profile (the ranks share the card).  Returns the line it prints
    (with ``rules``, the caller prints it)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    # the seed's dtypes (bf16, the MoE router f32), or all widened to f32
    params = M.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    if dtype == torch.float32:
        params = _map(params, lambda t: t.float())
    batches = list(make_batches(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                                seed=SEED), batch, seq_len,
                                num_batches=steps))
    by_step = dtype == torch.bfloat16 and cfg.moe is not None
    parts = [[b] for b in batches] if by_step else [batches]
    first_calls = 2 * cfg.num_moe_layers
    for fn in COUNTERS.values():
        fn.launches = 0
    state, held, refs, runs, ties = (params, None), [], [], [], []
    profile = contextlib.nullcontext() if rules is not None else \
        torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
    with profile as prof:
        for part in parts:
            with Routing() as cpu_routes:
                ref = _train_steps(*state[:1], part, cfg, lr, "cpu",
                                   state[1], rules)
            with Routing() as card_routes:
                run = _train_steps(*state[:1], part, cfg, lr, "cuda",
                                   state[1], rules)
            part_ties = routing_differences(
                cpu_routes.calls, card_routes.calls,
                len(cpu_routes.calls) if by_step else first_calls)
            again = bool(part_ties)
            if rules is not None:       # every rank reruns, or none
                flag = torch.tensor([float(again)])
                again = bool(collectives.all_reduce(flag, "max", None))
            if again:
                with Routing(replay=card_routes.calls) as rerun:
                    ref = _train_steps(*state[:1], part, cfg, lr, "cpu",
                                       state[1], rules)
                assert len(rerun.calls) == len(card_routes.calls)
            held.append(hold_training(ref, run, dtype, lr))
            ties += [(len(refs), c, g) for _, c, g in part_ties]
            refs.append(ref)
            runs.append(run)
            state = run[3]
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    assert launches == expected_training_launches(cfg, steps, dtype), \
        launches
    assert all(t.dtype == p.dtype for t, p in zip(runs[-1][1], tree_leaves(
        params))), {t.dtype for t in runs[-1][1]}
    name = str(dtype).removeprefix("torch.")
    if rules is None:
        # the backward's kernels for the dtype ran, the other dtype's did
        # not
        rows = device_rows(prof, 1)
        ran = assert_bwd_kernels(rows, dtype)
        if cfg.moe:
            ran += assert_moe_bwd_kernels(rows, dtype)
            ran += assert_moe_fwd_kernels(rows, dtype)
        else:
            assert not any("moe_" in n for n, _ in rows), rows
        kernels = ", ".join(sorted(n[:40] for n, _ in ran))
    else:
        kernels = "no profile: the ranks share the card"
    label = {k: v for k, v in changes.items() if k != "moe"}
    if "moe" in changes:
        label.update(d_ff_expert=cfg.moe.d_ff_expert,
                     layer_period=cfg.moe.layer_period)
    loss = [[round(h["loss"], 6) for r in rs for h in r[0]]
            for rs in (refs, runs)]
    gnorm = [[round(h["grad_norm"], 6) for r in rs for h in r[0]]
             for rs in (refs, runs)]
    where = "" if rules is None else \
        f" on rank {rules.mesh.rank} of the mesh {rules.mesh.shape}"
    line = (f"reduced {arch} {label or ''} trained {steps} steps in {name} "
          f"on cpu and cuda{where}"
          + (", each step's reference from the card's state before it"
             if by_step else "") + f": losses {loss[0]} / {loss[1]}, "
          f"grad_norm {gnorm[0]} / {gnorm[1]}; moments per leaf within "
          f"{max(g['moments']['mu'] for g in held):.3g} (mu) and "
          f"{max(g['moments']['nu'] for g in held):.3g} (nu) of the leaf's "
          f"largest; parameters: {sum(g['off'] for g in held)} of "
          f"{sum(g['total'] for g in held)} past 2e-6, largest difference "
          f"{max(g['worst'] for g in held):.3g}; launches K4 "
          f"{launches['prefill_attention']} forward, "
          f"{launches['prefill_attention_bwd']} backward, K7 "
          f"{launches['moe_ffn']} forward, {launches['moe_ffn_bwd']} "
          f"backward ({kernels}); "
          + (f"{len(ties)} router rows routed otherwise on the card (gaps "
             f"{sorted({round(g, 6) for _, _, g in ties})[:6]}, in (part, "
             f"call) {sorted({(p, c) for p, c, _ in ties})}), the CPU's "
             f"reference taken again under the card's routing" if ties
             else "the same routing on both"))
    if rules is None:
        print(line)
    return line


def check_no_backward():
    """Every kernel without a backward (K1, K2, K3, K5, K6) raises on a
    CUDA tensor that requires grad in grad mode, naming itself, and runs
    under ``torch.no_grad``; none returns a tensor that drops the gradient.
    K7, which has a backward, takes its gradient on the card: through
    autograd one forward and one backward launch, and the gradient that
    arrives equals the plain backward's within ``MOE_BWD_REL``."""
    dev = "cuda"
    q = torch.randn((2, 8, 64), device=dev, requires_grad=True)
    pool = torch.randn((4, 8, 2, 64), device=dev, requires_grad=True)
    req = torch.tensor([0, 0, 1, -1], dtype=torch.int32, device=dev)
    base = torch.tensor([0, 8, 0, 0], dtype=torch.int32, device=dev)
    pos = torch.tensor([12, 5], dtype=torch.int32, device=dev)
    flat = torch.randn((4, 64), device=dev, requires_grad=True)
    ids = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    values, scales = hops.quantize_blocks(flat.detach(), ids)
    calls = {
        "paged_decode_partials": lambda: pops.paged_decode_partials(
            q, pool, pool, req, base, pos, scale=0.125),
        "quantize_blocks": lambda: hops.quantize_blocks(flat, ids),
        "dequantize_blocks": lambda: hops.dequantize_blocks(
            flat, values, scales, ids),
        "gather_blocks": lambda: hops.gather_blocks(flat, ids),
        "copy_blocks": lambda: hops.copy_blocks(flat, flat.detach().clone(),
                                                ids, ids)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert f"{name}: the kernel has no backward" in str(e), e
        else:
            raise AssertionError(f"{name} cut a gradient without raising")
        with torch.no_grad():
            call()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    xd, wi, wg, wo = (torch.randn(s, generator=gen, device=dev).mul_(0.2)
                      for s in ((2, 16, 32), (2, 32, 48), (2, 32, 48),
                                (2, 48, 32)))
    dout = torch.randn(xd.shape, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (xd, wi, wg, wo)]
    f0, b0 = mops.moe_ffn.launches, mops.moe_ffn_bwd.launches
    got = torch.autograd.grad(mops.moe_ffn(*leaves), leaves, dout)
    torch.cuda.synchronize()
    assert (mops.moe_ffn.launches - f0, mops.moe_ffn_bwd.launches - b0) \
        == (1, 1)
    err = hold_moe_bwd(got, mops.moe_ffn_bwd_plain(xd, wi, wg, wo, dout),
                       torch.float32)
    print(f"kernels without a backward raise under grad on the card: "
          f"{', '.join(calls)}; moe_ffn's gradient arrives through its "
          f"backward kernels (one forward and one backward launch), "
          f"{max(err):.3g} from the plain backward (f32)")


def _expert_params(tree) -> int:
    """The parameters of the routed experts (each MoE layer's stacked wi,
    wg and wo; the shared expert and the router are not among them)."""
    if not isinstance(tree, dict):
        return 0
    if "router" in tree:
        return sum(tree[k].numel() for k in ("wi", "wg", "wo"))
    return sum(_expert_params(v) for v in tree.values())


def _model_flops(cfg, params, tokens, pairs):
    """A training step's flops: 8 per parameter a token passes through (6
    for the pass and the backward, 2 more for the recomputed pass): every
    parameter but the embedding's gather, and of an MoE layer's routed
    experts only the ``top_k`` of ``num_experts`` each token is sent to;
    attention's products over the kept pairs, forward twice.  Returns
    (flops, the formula as text)."""
    n_params = M.param_count(params)
    embed = cfg.vocab_size * cfg.d_model
    experts = _expert_params(params)
    share = cfg.moe.top_k / cfg.moe.num_experts if cfg.moe else 1.0
    active = n_params - embed - experts * (1 - share)
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    fwd = fops.prefill_attention_cost(1, 1, 1, nq, nkv, hd, 2,
                                      pairs=pairs).flops
    bwd = fops.prefill_attention_bwd_cost(1, 1, 1, nq, nkv, hd, 2,
                                          pairs=pairs).flops
    attn = cfg.num_layers * (2 * fwd + bwd)
    text = (f"8 x ({n_params / 1e9:.3f} B - {embed / 1e9:.3f} B embedding"
            + (f" - {experts / 1e9:.3f} B experts x (1 - {cfg.moe.top_k}/"
               f"{cfg.moe.num_experts})" if experts else "")
            + f" = {active / 1e9:.3f} B) x {tokens} tokens + "
            f"{cfg.num_layers} layers x (2 x {fwd / 1e12:.3f} + "
            f"{bwd / 1e12:.3f}) TFLOP attention over {pairs} pairs a head")
    return 8 * active * tokens + attn, text


def train_path(arch="h2o-danube-3-4b", steps=5, batch=1, seq_len=8192,
               lr=3e-4, warmup=100, total=1000):
    """Full-width training on the card: ``abstract_params`` reckons the
    footprint (parameters and their gradients in the parameters' dtypes,
    AdamW's two f32 moments) before anything is allocated; then weights
    from the seed and ``steps`` fused steps (``train_step``: loss,
    gradients through K4's forward and backward and, for an MoE model,
    K7's, AdamW) on ``make_batches``'s sequences, each step timed on the
    host clock around a synchronised step, the learning rate ``train``'s
    schedule (``cosine_lr``) at the first steps of a ``warmup``-step warmup
    to ``lr``.  The launch counts are set to 0 just before the steps and
    read just after: ``expected_training_launches``, exactly.  Then one
    step profiled for where the time goes, K4's and K7's forward and
    backward rows split out.  Returns (launch counts, the numbers kept)."""
    cfg = get_config(arch)
    ap = M.abstract_params(cfg)
    n_params = M.param_count(ap)
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(ap))
    state = 2 * p_bytes + 8 * n_params
    layer_in = batch * seq_len * cfg.d_model * 2
    print(f"{arch} training: {n_params / 1e9:.3f} B parameters; reckoned "
          f"before allocating: parameters {p_bytes / 1e9:.2f} GB, gradients "
          f"{p_bytes / 1e9:.2f} GB (the parameters' dtypes), AdamW moments "
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
    flops, formula = _model_flops(cfg, ap, batch * seq_len, pairs)
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
              f"{vals['loss']:.5f}, nll {vals['nll']:.5f}, aux "
              f"{vals['aux']:.5f}, grad_norm {vals['grad_norm']:.5f}, lr "
              f"{cur_lr:.2e}")
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    expect = expected_training_launches(cfg, steps)
    moe_layers = cfg.num_moe_layers
    print(f"{arch} training: launches {launches} (predicted: K4 forward "
          f"{2 * cfg.num_layers} and backward {cfg.num_layers} a step, K7 "
          f"forward {2 * moe_layers} and backward {moe_layers} a step, "
          f"nothing else)")
    assert launches == expect, (launches, expect)
    assert int(opt.step) == steps
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(walls[1:]))
    mfu = flops / steady / BF16_FLOPS
    print(f"{arch} training: step wall {steady * 1e3:.1f} ms (mean of steps "
          f"1-{steps - 1}; step 0 {walls[0] * 1e3:.1f} ms), "
          f"{batch * seq_len / steady:.0f} tokens/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB), model flops "
          f"{flops / 1e12:.1f} TFLOP a step ({formula}), {100 * mfu:.1f}% "
          f"of the bf16 peak")
    b = next_batch()
    def training_kernels(rows):
        assert_bwd_kernels(rows, torch.bfloat16)
        if moe_layers:
            assert_moe_bwd_kernels(rows, torch.bfloat16)
            assert_moe_fwd_kernels(rows, torch.bfloat16)

    rows = trace_rows(lambda: train_step(params, opt, b, cfg, lr=cur_lr), 1,
                      retake_s=TRACE_RETAKE_S, want=holds(training_kernels))
    training_kernels(rows)
    busy = sum(ms for _, ms in rows)
    split = {"k4_forward_ms": "flash_prefill", "k4_backward_ms": "flash_bwd",
             "k7_forward_ms": ("moe_train_", "moe_pad_rows"),
             "k7_backward_ms": "moe_bwd_"}
    parts = {k: sum(ms for n, ms in rows
                    if any(w in n for w in ((v,) if isinstance(v, str)
                                            else v)))
             for k, v in split.items()}
    print(f"{arch} training: one step profiled: {busy:.1f} ms device-busy "
          f"({100 * busy / (steady * 1e3):.1f}% of the mean step wall), K4 "
          f"forward {parts['k4_forward_ms']:.1f} ms, K4 backward "
          f"{parts['k4_backward_ms']:.1f} ms, K7 forward "
          f"{parts['k7_forward_ms']:.1f} ms, K7 backward "
          f"{parts['k7_backward_ms']:.1f} ms")
    for name, ms in rows[:12]:
        print(f"  {ms:9.3f} ms/step  {name[:90]}")
    del params, opt, b
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(steps=steps, tokens_per_step=batch * seq_len,
                          step_ms=[w * 1e3 for w in walls],
                          steady_step_ms=steady * 1e3,
                          tokens_per_s=batch * seq_len / steady,
                          peak_gib=peak / 2 ** 30, mfu=mfu,
                          model_tflop=flops / 1e12, device_busy_ms=busy,
                          **parts, losses=[h["loss"] for h in hist],
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

    wall_ms, rows = wall_and_rows(step, steps)
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

    wall_ms, rows = wall_and_rows(
        lambda: M.forward(params, batch, cfg, want_kv=True), 1, 1)
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
            "prefill_attention_bwd": fops.prefill_attention_bwd,
            "moe_ffn_bwd": mops.moe_ffn_bwd,
            "moe_ffn_train": mops.moe_ffn_train}


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
    t_path = time.perf_counter()
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
    # serving runs no backward and no training forward
    assert not any(launches[n] for n in ("prefill_attention_bwd",
                                         "moe_ffn_bwd", "moe_ffn_train")), \
        launches
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
    print(f"{arch}: the path took {time.perf_counter() - t_path:.1f} s")
    return launches, k1, extra


# ---------------------------------------------------------------------------
# the audio family (musicgen-medium) at model level, and the harvested peer
# tier read in place
# ---------------------------------------------------------------------------


def audio_rows(cfg, frames, gen, device):
    """One row per entry of ``frames``: (1, n, ncb) codebook tokens and
    (1, npre, d) conditioning embeddings (bf16, std 0.5), drawn from
    ``gen`` (a CPU generator: the same rows on the CPU and the card)."""
    ncb, npre = cfg.modality.num_codebooks, cfg.modality.num_prefix_embeddings
    rows = []
    for n in frames:
        toks = torch.randint(0, cfg.vocab_size, (1, n, ncb), generator=gen,
                             dtype=torch.int32)
        pre = 0.5 * torch.randn((1, npre, cfg.d_model), generator=gen)
        rows.append((toks.to(device), pre.to(torch.bfloat16).to(device)))
    return rows


def audio_batch(toks, pre):
    n = pre.shape[1] + toks.shape[1]
    return {"tokens": toks, "prefix_embeddings": pre,
            "positions": torch.arange(n, dtype=torch.int32,
                                      device=toks.device)[None]}


def audio_pools(cfg, kvs, bs, steps, seed, device):
    """Each row's prefill KV (``kvs``: the stacked (L, 1, P, nkv, hd) k and
    v of each row) in ``bs``-token blocks of a fetch pool with room for
    ``steps`` more positions a row, and the in-place layout with the
    first half of each row's prefill blocks on a peer pool
    (``deal_pools``).  Returns the fetch, local and peer ``KVPools``, the
    (steps, b) append slots and offsets of each step, and the blocks on
    the peer."""
    P = [k.shape[2] for k, _ in kvs]

    def fill(pk, pv, where):
        for (r, j), slot in where.items():
            lo, hi = j * bs, min(j * bs + bs, P[r])
            for t, kv in zip((pk, pv), kvs[r]):
                if lo < hi:
                    t[:, slot, :hi - lo] = kv[:, 0, lo:hi].float()

    fetch, local, peer, where = deal_pools(
        M.num_kv_layers(cfg), P, bs, cfg.num_kv_heads,
        cfg.resolved_head_dim, lambda r, j: j < (P[r] // bs + 1) // 2,
        seed, steps, device, fill)
    pos = np.asarray(P)[None] + np.arange(steps)[:, None]
    aslot = [[where[(r, p // bs)] for r, p in enumerate(row)] for row in pos]
    cast = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731,E501
    return (fetch, local, peer, cast(aslot), cast(pos % bs),
            int((peer.slot_req >= 0).sum()))


def audio_decode(params, cfg, kv, peer, first, P, aslot, aoff, feed=None):
    """``len(aslot)`` decode steps of every row from positions ``P``, the
    first fed ``first`` (b, ncb), each later one the previous step's
    argmax, or ``feed[t]`` where given; in place where ``peer`` is given
    (``harvest_inplace``).  Returns the (steps, b, ncb) argmax tokens and
    the (steps, b, ncb, V) logits."""
    dev = first.device
    pos0 = torch.as_tensor(P, dtype=torch.int32, device=dev)
    state = M.DecodeState(tokens=first, pos=pos0, kv=kv, peer=peer)
    toks, logits = [], []
    for t in range(aslot.shape[0]):
        state = state._replace(
            tokens=first if t == 0 else (feed[t - 1] if feed is not None
                                         else toks[-1]),
            pos=pos0 + t, kv=state.kv._replace(append_slot=aslot[t],
                                               append_off=aoff[t]))
        lg, state = M.serve_step(params, state, cfg,
                                 harvest_inplace=peer is not None)
        toks.append(state.tokens)
        logits.append(lg)
    return torch.stack(toks), torch.stack(logits)


def near_ties(ref, got):
    """Where ``got``'s argmax token differs from ``ref``'s: every such
    (step, row, codebook) must be a near tie, ``ref``'s top-1/top-2 gap no
    more than twice that vector's largest difference d (the guard of the
    port's engine tests, tests/test_torch_engine.py); and at least half
    the vectors must be decided (gap above 2 d).  Returns the ties that
    differ, each with its gap and d, and the decided count."""
    ref, got = ref.float(), got.float()
    d = (ref - got).abs().amax(-1)
    top = torch.topk(ref, 2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    decided = int((gap > 2 * d).sum())
    differ = torch.argmax(ref, -1) != torch.argmax(got, -1)
    ties = [(tuple(int(i) for i in ix), float(gap[tuple(ix)]),
             float(d[tuple(ix)])) for ix in torch.nonzero(differ).tolist()]
    assert all(g <= 2 * dd for _, g, dd in ties), ties
    assert decided >= d.numel() // 2, (decided, d.numel())
    return ties, decided


def check_reduced_audio(steps=16, frames=(29, 13), bs=8):
    """Reduced musicgen-medium (2 layers, 4 codebooks, 8 prefix
    embeddings) at model level on the CPU (plain versions) and on the card
    (K4, K1), f32 weights as ``check_reduced_tokens`` holds the other
    families: each row prefilled alone, then ``steps`` decode steps in
    fetch mode and ``steps`` in place from the same prefill (the first
    half of each row's blocks on the peer), each run fed its own argmax;
    the (steps, b, ncb) tokens identical on both devices in both modes."""
    cfg = get_config(MUSICGEN).reduced()
    params = _map(M.init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu"), lambda t: t.float())
    out = {}
    for device in ("cpu", "cuda"):
        p = _map(params, lambda t: t.to(device))
        rows = audio_rows(cfg, frames, torch.Generator().manual_seed(SEED),
                          device)
        pre = [M.prefill(p, audio_batch(*r), cfg) for r in rows]
        first = torch.cat([torch.argmax(lg, -1) for lg, _ in pre]).to(
            torch.int32)
        kvs = [o.kv for _, o in pre]
        P = [k.shape[2] for k, _ in kvs]
        fetch, local, peer, aslot, aoff, _ = audio_pools(
            cfg, kvs, bs, steps, SEED, device)
        tf, _ = audio_decode(p, cfg, fetch, None, first, P, aslot, aoff)
        ti, _ = audio_decode(p, cfg, local, peer, first, P, aslot, aoff)
        out[device] = (tf.cpu(), ti.cpu())
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b), (a, b)
    return out["cuda"]


def audio_path(frames=MUSICGEN_FRAMES, steps=MUSICGEN_STEPS, bs=16):
    """musicgen-medium at full width and depth (48 layers, 1.38 B
    parameters, bf16, seed 0) at model level (the serving engine refuses
    the audio family, as the JAX engine cannot serve it): 4 rows of 64
    conditioning embeddings and an audio prompt of ``frames`` frames (5-30
    s at EnCodec's 50 Hz), each prefilled alone through K4 and placed into
    ``bs``-token blocks; then ``steps`` decode steps in fetch mode (every
    block local) and ``steps`` in place (the first half of each row's
    prefill blocks on a peer pool, ``harvest_inplace``) from the same
    prefill, both fed the fetch mode's tokens.  Launches as predicted;
    the two modes' argmax tokens equal but for named near ties; the in-place
    logits against a full-sequence forward over the same tokens.  Then
    each mode's decode step and one prefill profiled.  Returns (launch
    counts of prefill and decode, numbers)."""
    cfg = get_config(MUSICGEN)
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    print(f"{MUSICGEN} full width, {L} layers: "
          f"{M.param_count(params) / 1e9:.3f} B params initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    rows = audio_rows(cfg, frames, torch.Generator().manual_seed(SEED),
                      "cuda")
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pre, prefill_ms = [], []
    for r in rows:
        t1 = time.perf_counter()
        pre.append(M.prefill(params, audio_batch(*r), cfg))
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t1))
    k4 = fops.prefill_attention.launches
    assert k4 == L * len(rows), k4
    first = torch.cat([torch.argmax(lg, -1) for lg, _ in pre]).to(
        torch.int32)
    kvs = [o.kv for _, o in pre]
    P = [k.shape[2] for k, _ in kvs]
    del pre
    fetch, local, peer, aslot, aoff, n_moved = audio_pools(
        cfg, kvs, bs, steps, SEED, "cuda")
    del kvs
    t1 = time.perf_counter()
    tf, lf = audio_decode(params, cfg, fetch, None, first, P, aslot, aoff)
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t1
    k1_fetch = pops.paged_decode_partials.launches
    t1 = time.perf_counter()
    ti, li = audio_decode(params, cfg, local, peer, first, P, aslot, aoff,
                          feed=tf)
    torch.cuda.synchronize()
    inplace_s = time.perf_counter() - t1
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    k1_inplace = launches["paged_decode_partials"] - k1_fetch
    print(f"{MUSICGEN}: rows at positions {P} "
          f"({cfg.modality.num_prefix_embeddings} conditioning positions "
          f"and {list(frames)} frames), {int((fetch.slot_req >= 0).sum())} "
          f"blocks of {bs}, {n_moved} of them on the peer in place; "
          f"launches: K4 {k4} (predicted {L} x {len(rows)} prefills = "
          f"{L * len(rows)}), K1 {k1_fetch} fetch (predicted {L} x {steps} "
          f"= {L * steps}), {k1_inplace} in place (predicted 2 x {L} x "
          f"{steps} = {2 * L * steps}); all: {launches}")
    assert k1_fetch == L * steps and k1_inplace == 2 * L * steps
    assert launches["prefill_attention"] == L * len(rows)
    assert sum(launches.values()) == launches["prefill_attention"] \
        + launches["paged_decode_partials"], launches
    assert torch.isfinite(lf.float()).all() and torch.isfinite(
        li.float()).all()
    assert tuple(tf.shape) == (steps, len(rows), cfg.modality.num_codebooks)
    ties, decided = near_ties(lf, li)
    same = int((tf == ti).sum())
    apart = (lf.float() - li.float()).abs().max().item()
    print(f"{MUSICGEN}: logits max |in place - fetch| {apart:.4g} "
          f"(tolerance {INPLACE_LOGIT_TOL}); argmax tokens equal at {same} "
          f"of {tf.numel()} (step, row, codebook), {decided} decided (gap > "
          f"2 d); the near ties that differ (index, gap, d): {ties}")
    assert apart <= INPLACE_LOGIT_TOL, apart
    # the in-place logits against the full-sequence forward over the same
    # tokens: step t's input is the fed token at position P + t
    errs = []
    for r, (toks, pre_emb) in enumerate(rows):
        seq = torch.cat([toks, first[r:r + 1, None], tf[:-1, r][None]], 1)
        full, _ = M.forward(params, audio_batch(seq, pre_emb), cfg)
        ref = full[0, P[r]:P[r] + steps]
        errs.append((li[:, r].float() - ref.float()).abs().amax().item())
        del full
    err = max(errs)
    print(f"{MUSICGEN}: in-place logits against a full-sequence forward "
          f"over the same tokens: max |diff| per row {errs}, tolerance "
          f"{AUDIO_FORWARD_TOL}")
    assert err <= AUDIO_FORWARD_TOL, errs
    numbers = dict(positions=P, blocks_on_peer=n_moved,
                   prefill_wall_ms=prefill_ms,
                   decode_wall_ms=dict(fetch=1e3 * fetch_s / steps,
                                       inplace=1e3 * inplace_s / steps),
                   near_ties=ties, inplace_max_abs_err=apart,
                   forward_max_abs_err=err)
    for mode, kv, pr in (("fetch", fetch, None), ("in place", local, peer)):
        state = M.DecodeState(
            tokens=first, pos=torch.as_tensor(P, dtype=torch.int32,
                                              device="cuda"),
            kv=kv._replace(append_slot=aslot[0], append_off=aoff[0]),
            peer=pr)

        def step():
            lg, _ = M.serve_step(params, state, cfg,
                                 harvest_inplace=pr is not None)
            lg.float().cpu()

        wall, rows_ = wall_and_rows(step)
        busy = sum(ms for _, ms in rows_)
        k1 = sum(ms for n, ms in rows_ if any(k in n for k in K1_KERNELS))
        print(f"{MUSICGEN}: decode step profile, {mode} ({len(P)} rows at "
              f"{P}): {wall:.2f} ms wall, {busy:.3f} ms device-busy "
              f"({100 * busy / wall:.1f}%), K1 {k1:.3f} ms")
        for name, ms in rows_[:5]:
            print(f"  {ms:8.3f} ms/step  {name[:90]}")
        numbers[f"step_{mode.replace(' ', '')}"] = dict(
            wall_ms=wall, busy_ms=busy, k1_ms=k1,
            top=[(n[:60], ms) for n, ms in rows_[:5]])
    batch = audio_batch(*rows[-1])
    wall, rows_ = wall_and_rows(lambda: M.prefill(params, batch, cfg), 1, 1)
    busy = sum(ms for _, ms in rows_)
    k4_ms = sum(ms for n, ms in rows_ if "flash_prefill" in n)
    print(f"{MUSICGEN}: prefill profile ({P[-1]} positions): {wall:.2f} ms "
          f"wall, {busy:.2f} ms device-busy ({100 * busy / wall:.1f}%), K4 "
          f"{k4_ms:.3f} ms ({100 * k4_ms / busy:.1f}% of device time); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    numbers["prefill_profile"] = dict(positions=P[-1], wall_ms=wall,
                                      busy_ms=busy, k4_ms=k4_ms)
    return launches, numbers


def inplace_step(label, bs, pos, peer_of):
    """An ``on_model`` hook: one decode step of the served model over
    random f32 pools, rows at ``pos``, in fetch mode (every block local)
    and in place (the blocks ``peer_of(r, j)`` names on a peer pool,
    ``deal_pools``), the same tokens and KV; the launch counts set to 0
    before and read after.  The in-place logits within
    ``INPLACE_LOGIT_TOL`` of the fetch step's, the argmax equal but for
    near ties; K1 launched once a KV layer in fetch mode, twice in place.
    Each mode's step profiled.  Returns (launch counts, numbers)."""
    def hook(cfg, params):
        L, b = M.num_kv_layers(cfg), len(pos)
        for fn in COUNTERS.values():
            fn.launches = 0
        kv, local, peer, _ = deal_pools(L, pos, bs, cfg.num_kv_heads,
                                        cfg.resolved_head_dim, peer_of,
                                        SEED + 12)
        tokens = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
            3, 250, size=b).astype(np.int32)).cuda()
        fetch = M.DecodeState(
            tokens=tokens, pos=torch.tensor(pos, dtype=torch.int32,
                                            device="cuda"),
            kv=kv, peer=None, states=M.init_states(cfg, b, "cuda"))
        inplace = fetch._replace(kv=local, peer=peer)
        lf, _ = M.serve_step(params, fetch, cfg)
        k1_fetch = pops.paged_decode_partials.launches
        li, _ = M.serve_step(params, inplace, cfg, harvest_inplace=True)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in COUNTERS.items()}
        k1_inplace = launches["paged_decode_partials"] - k1_fetch
        assert (k1_fetch, k1_inplace) == (L, 2 * L), (k1_fetch, k1_inplace)
        err = (lf.float() - li.float()).abs().max().item()
        ties, decided = near_ties(lf, li)
        on_peer = int((peer.slot_req >= 0).sum())
        print(f"{label}: one decode step, rows at {list(pos)}, {on_peer} of "
              f"{int((kv.slot_req >= 0).sum())} blocks of {bs} on the peer: "
              f"K1 {k1_fetch} launches fetch, {k1_inplace} in place "
              f"(predicted {L} and {2 * L}); logits max |in place - fetch| "
              f"{err:.4g} (tolerance {INPLACE_LOGIT_TOL}); argmax differs at "
              f"near ties {ties} ({decided} of {b} decided)")
        assert err <= INPLACE_LOGIT_TOL, err
        numbers = dict(positions=list(pos), blocks_on_peer=on_peer,
                       max_abs_err=err, near_ties=ties, k1_fetch=k1_fetch,
                       k1_inplace=k1_inplace, bs=bs)
        for mode, st in (("fetch", fetch), ("inplace", inplace)):
            def step():
                lg, _ = M.serve_step(params, st, cfg,
                                     harvest_inplace=st.peer is not None)
                lg.float().cpu()

            wall, rows = wall_and_rows(step)
            busy = sum(ms for _, ms in rows)
            k1 = sum(ms for n, ms in rows if any(k in n for k in K1_KERNELS))
            print(f"{label}: decode step {mode}: {wall:.2f} ms wall, "
                  f"{busy:.3f} ms device-busy, K1 {k1:.3f} ms; largest rows "
                  f"{[(n[:40], round(ms, 3)) for n, ms in rows[:3]]}")
            numbers[mode] = dict(wall_ms=wall, busy_ms=busy, k1_ms=k1)
        return launches, numbers

    return hook


# ---------------------------------------------------------------------------
# sharded decode: two ranks on the mesh (data 1, model 2)
# ---------------------------------------------------------------------------

#: the sharded phase's mesh: each pool's slots split over both ranks
#: (``kv_blocks`` = (data, model)), an MoE layer's experts over ``model``,
#: the batch whole on each rank (``data`` 1)
SHARD_MESH = ((1, 2), ("data", "model"))
#: the decode steps of each sharded case, sharded and unsharded
SHARD_STEPS = 8
#: largest |sharded - unsharded| logit over a case's 8 steps: the ranks'
#: partials merge in another order than one K1 call's splits, which moves
#: the attention output by f32 ulps and, where one rounds to bf16
#: otherwise, the residual stream by a bf16 step, carried through the
#: layers and, through the appended k and v, into the later steps; twice
#: the in-place mode's bound for its one step, 16 bf16 steps of a logit
#: in [4, 8) (measured on an H100: 0.15-0.22 at yi-6b and danube)
SHARD_LOGIT_TOL = 2 * INPLACE_LOGIT_TOL
#: largest |sharded - unsharded| entry of the k and v the steps appended
#: (a row's k of a layer past the first reads a residual stream a bf16
#: step or a few apart, times its weights; measured on an H100:
#: 0.15-0.24); every other entry of each rank's pool shard equal bit for
#: bit
SHARD_KV_TOL = 0.5
#: case -> (arch, block size, each row's first decode position, local
#: slots, peer slots, which of a row's blocks lie on the peer (in place)
#: or None (fetch mode))
SHARD_CASES = {
    # 24 slots of 8: the rows' 21 blocks over 8 steps, 12 a rank
    "yi-6b": ("yi-6b", 8, (41, 24, 33, 17), 24, None, None),
    # each row's first block on a peer pool of 8 slots, 4 a rank
    "yi-6b in place": ("yi-6b", 8, (41, 24, 33, 17), 24, 8,
                       lambda r, j: j == 0),
    # 800 slots of 16, 400 a rank, rows inside and past the 4,096 window
    "h2o-danube-3-4b": ("h2o-danube-3-4b", 16, (5999, 4700), 800, None,
                        None),
    # 8 of 16 experts a rank, the KV as yi-6b's
    PHI_TINY: (PHI_TINY, 8, (41, 24, 33, 17), 24, None, None),
}


def _tp_tagged():
    """(calls, host ms) of tensor parallelism's collectives since the
    stats were last reset (``collectives.tagged``)."""
    calls, sec = collectives.stats["tagged"].get(
        collectives.TENSOR_PARALLEL, (0, 0.0))
    return calls, sec * 1e3


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _recurrent_gib(params) -> float:
    """GiB of the recurrent layers' own leaves in ``params`` (Mamba2's, the
    mLSTM and sLSTM blocks'): what the head split divides over ``model``."""
    parts = [params[k] for k in ("supers",) if k in params]
    if "mamba_layers" in params:
        parts.append(params["mamba_layers"]["mamba"])
    return sum(_tree_bytes(t) for t in parts) / 2 ** 30


#: the sharded decode cases' depth, cut for the run's time: tensor
#: parallelism's collectives doubled a step's wall over gloo (yi-6b 232-365
#: ms at 32 layers before, 647-696 ms with them, an H100 80GB HBM3, 700 W);
#: then from 8 to 4 layers, to pay for the served paths' and
#: musicgen-medium's whole depths (a whole run at 8 took 805 s, the
#: phase 59.4 s, against 820)
SHARD_LAYERS = {"yi-6b": 4, "h2o-danube-3-4b": 4, PHI_TINY: 4}


def _same_on_ranks(tensors, what):
    """Every rank holds the same ``tensors`` (each one's sum, taken in
    f32 without a widened copy, compared over the world)."""
    fp = torch.stack([t.sum(dtype=torch.float32) for t in tensors])
    hi, lo = fp.clone(), -fp
    collectives.all_reduce(hi, "max", None)
    collectives.all_reduce(lo, "max", None)
    assert torch.equal(hi, fp) and torch.equal(-lo, fp), \
        f"the ranks' {what} differ"


def _lockstep_profile(step, rank, world, iters=2, warmup=2):
    """(wall ms per step, device rows per step, the collectives' host ms
    per step) of ``step``, which every rank calls in lockstep (it holds
    collectives): the wall and the time inside the collectives over
    ``iters`` steps after ``warmup``, then one rank at a time profiles
    ``iters`` steps while the others run them unprofiled (two processes'
    CUPTI on one card are left untried); a round whose trace came back
    empty on some rank is taken again, up to three times."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    collectives.reset_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    coll = collectives.stats["seconds"] * 1e3 / iters
    for _ in range(3):
        rows = []
        for who in range(world):
            if who == rank:
                rows = device_rows(profiled(step, iters), iters)
            else:
                for _ in range(iters):
                    step()
                torch.cuda.synchronize()
        empty = torch.tensor([float(not any(t > 0 for _, t in rows))],
                             device="cuda")
        collectives.all_reduce(empty, "max", None)
        if not empty.item():
            return wall, rows, coll
    raise RuntimeError("three lockstep traces came back without a device "
                       "row")


def _sharded_case(case, cfg, params, rules, rank, world):
    """One sharded case on this rank: the full pools dealt as
    ``SHARD_CASES`` says (the same on every rank, from a seed), this rank's
    shard of them and of the experts (``bridge.shard_decode``); then
    ``SHARD_STEPS`` unsharded steps from random tokens, each fed the last
    step's argmax, and the same steps sharded, fed the unsharded tokens,
    the launch counts set to 0 just before them and read just after.
    Held: the logits within ``SHARD_LOGIT_TOL``, the argmax equal but for
    near ties, the rank's pool shards against the matching slots of the
    unsharded pools (appended entries within ``SHARD_KV_TOL``, the rest bit
    for bit, the peer unchanged), K1 once a KV layer a step (twice in
    place), K7 once an MoE layer a step over the rank's own experts.  An
    MoE model's router may send a row to another expert where its k-th and
    (k + 1)-th probabilities nearly tie: every such row of the first step
    must be a near tie the runs' roundings explain, and the sharded steps
    run again from the same shard under the unsharded run's routing
    (``Routing``'s replay) give the numbers held.  Then one sharded step
    profiled in lockstep.  Returns its numbers, ``problems`` naming what
    failed."""
    _, bs, pos, slots, peer_slots, peer_of = SHARD_CASES[case]
    L, b = M.num_kv_layers(cfg), len(pos)
    inplace = peer_of is not None
    fetch, local, peer, where = deal_pools(
        L, pos, bs, cfg.num_kv_heads, cfg.resolved_head_dim,
        peer_of or (lambda r, j: False), SEED + 13, steps=SHARD_STEPS,
        device="cuda", slots=slots, peer_slots=peer_slots or None)
    _same_on_ranks([fetch.pool_k, peer.pool_k], "pools")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tokens = torch.randint(3, 250, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    q0 = torch.tensor(pos, dtype=torch.int32, device="cuda")
    full = M.DecodeState(tokens=tokens, pos=q0, kv=local if inplace else
                         fetch, peer=peer if inplace else None)
    p_r, st_r = shard_decode(params, full, cfg, rules)
    # a second copy of the shard's pools, for the replayed run
    st_r2 = st_r._replace(kv=st_r.kv._replace(
        pool_k=st_r.kv.pool_k.clone(), pool_v=st_r.kv.pool_v.clone()))
    n_loc = st_r.kv.slot_req.shape[0]
    lo = rules.mesh.axis_index(kv_block_axes(rules)) * n_loc

    def at(st, t, toks):
        p = [q + t for q in pos]
        return st._replace(tokens=toks, pos=q0 + t, kv=st.kv._replace(
            append_slot=torch.tensor([where[(r, q // bs)] for r, q in
                                      enumerate(p)], dtype=torch.int32,
                                     device="cuda"),
            append_off=torch.tensor([q % bs for q in p], dtype=torch.int32,
                                    device="cuda")))

    st, ref, feed = full, [], [tokens]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record = Routing if cfg.moe is not None else contextlib.nullcontext
    with record() as ref_routes:
        for t in range(SHARD_STEPS):
            lg, st = M.serve_step(params, at(st, t, feed[-1]), cfg,
                                  harvest_inplace=inplace)
            ref.append(lg.float())
            feed.append(st.tokens)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
    for fn in COUNTERS.values():
        fn.launches = 0
    collectives.reset_stats()
    st, got = st_r, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record() as routes:
        for t in range(SHARD_STEPS):
            lg, st = M.serve_step(p_r, at(st, t, feed[t]), cfg,
                                  harvest_inplace=inplace, rules=rules)
            got.append(lg.float())
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    coll_calls = collectives.stats["calls"] // SHARD_STEPS
    tp_calls, tp_ms = _tp_tagged()
    # an MoE model's rows that the sharded run routed otherwise: each in
    # the first step a near tie the runs' roundings explain; then the
    # sharded steps again under the unsharded routing, and these are held
    rerouted, routed_err = [], None
    if cfg.moe is not None:
        rerouted = routing_differences(ref_routes.calls, routes.calls,
                                       cfg.num_moe_layers)
        routed_err = max((a - b).abs().max().item()
                         for a, b in zip(ref, got))
        st, got = st_r2, []
        with Routing(replay=ref_routes.calls):
            for t in range(SHARD_STEPS):
                lg, st = M.serve_step(p_r, at(st, t, feed[t]), cfg,
                                      harvest_inplace=inplace, rules=rules)
                got.append(lg.float())
    want_k1 = L * SHARD_STEPS * (2 if inplace else 1)
    want_k7 = cfg.num_moe_layers * SHARD_STEPS
    problems = []
    if (launches["paged_decode_partials"], launches["moe_ffn"]) != \
            (want_k1, want_k7) or any(
                n for k, n in launches.items()
                if k not in ("paged_decode_partials", "moe_ffn")):
        problems.append(f"launches {launches}, K1 and K7 predicted "
                        f"{want_k1} and {want_k7}")
    experts = None
    if cfg.moe is not None:
        experts = p_r["layers"]["moe"]["wi"].shape[1]
        if experts != cfg.moe.num_experts // rules.axis_size("model"):
            problems.append(f"{experts} experts on the rank")
    ref, got = torch.stack(ref), torch.stack(got)
    if not torch.isfinite(got).all():
        problems.append("non-finite logits")
    step_err = (ref - got).abs().amax(dim=(1, 2)).tolist()
    err = max(step_err)
    if err > SHARD_LOGIT_TOL:
        problems.append(f"logits {err} apart")
    # every argmax that differs must be a near tie: the unsharded step's
    # top-1/top-2 gap within twice that vector's largest difference
    d = (ref - got).abs().amax(-1)
    top = torch.topk(ref, 2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    decided = int((gap > 2 * d).sum())
    ties = [(tuple(ix), round(float(gap[tuple(ix)]), 5),
             round(float(d[tuple(ix)]), 5)) for ix in torch.nonzero(
                 torch.argmax(ref, -1) != torch.argmax(got, -1)).tolist()]
    if any(g > 2 * dd for _, g, dd in ties):
        problems.append(f"tokens differ past near ties: {ties}")
    # the pools: appended entries near, the rest bit for bit
    appended = torch.zeros((n_loc, bs), dtype=torch.bool, device="cuda")
    for t in range(SHARD_STEPS):
        for r, q in enumerate(pos):
            s = where[(r, (q + t) // bs)] - lo
            if 0 <= s < n_loc:
                appended[s, (q + t) % bs] = True
    kv_err = 0.0
    for mine, whole in ((st.kv.pool_k, full.kv.pool_k),
                        (st.kv.pool_v, full.kv.pool_v)):
        whole = whole[:, lo:lo + n_loc]
        if not torch.equal(mine[:, ~appended], whole[:, ~appended]):
            problems.append("a pool entry the steps did not write differs")
        kv_err = max(kv_err, (mine[:, appended] - whole[:, appended]).abs()
                     .max().item() if appended.any() else 0.0)
    if kv_err > SHARD_KV_TOL:
        problems.append(f"appended kv {kv_err} apart")
    if inplace:
        n_p = st.peer.slot_req.shape[0]
        p_lo = rules.mesh.axis_index(kv_block_axes(rules)) * n_p
        if not torch.equal(st.peer.pool_k, peer.pool_k[:, p_lo:p_lo + n_p]):
            problems.append("the peer shard changed")
    last = at(st, SHARD_STEPS - 1, feed[SHARD_STEPS - 1])

    def step():
        lg, _ = M.serve_step(p_r, last, cfg, harvest_inplace=inplace,
                             rules=rules)
        lg.float().cpu()        # the engine samples on the host

    wall, rows, coll_ms = _lockstep_profile(step, rank, world)
    busy = sum(ms for _, ms in rows)
    k1 = sum(ms for n, ms in rows if any(k in n for k in K1_KERNELS))
    k7 = sum(ms for n, ms in rows if "moe_ffn" in n)
    nccl = sum(ms for n, ms in rows if "nccl" in n.lower())
    copies = sum(ms for n, ms in rows if "Memcpy" in n)
    owned = int((st_r.kv.slot_req >= 0).sum())
    return dict(layers=cfg.num_layers, positions=list(pos),
                vectors=SHARD_STEPS * b, slots=slots,
                slots_here=n_loc,
                owned_here=owned, steps=SHARD_STEPS, launches=launches,
                experts_here=experts, max_abs_err=err,
                step_max_abs_err=[round(e, 5) for e in step_err],
                near_ties=ties, decided=decided, kv_max_abs_err=kv_err,
                rerouted=[(i // cfg.num_moe_layers, i % cfg.num_moe_layers,
                           r, round(g, 6)) for i, r, g in rerouted],
                max_abs_err_own_routing=routed_err, problems=problems,
                sharded_loop_ms=sharded_ms, unsharded_loop_ms=unsharded_ms,
                collectives_per_step=coll_calls,
                tp_collectives_per_step=tp_calls // SHARD_STEPS,
                tp_collectives_ms=tp_ms / SHARD_STEPS,
                param_bytes_here=_tree_bytes(p_r),
                param_bytes_whole=_tree_bytes(params),
                wall_ms=wall, busy_ms=busy,
                k1_ms=k1, k7_ms=k7, collectives_ms=coll_ms,
                collectives_share=coll_ms / wall, nccl_ms=nccl,
                memcpy_ms=copies, top=[(n[:50], round(ms, 4))
                                       for n, ms in rows[:4]])


def sharded_rank(rank, world, backend):
    """One rank of the sharded phase (run by ``launch``): its card (its
    own with NCCL, the one card with gloo), the mesh and rules, then each
    model drawn from the seed (the same weights on every rank, checked)
    and its cases.  Returns {case: numbers}."""
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rules = make_rules(Mesh(*SHARD_MESH))
    out = {}
    for arch in dict.fromkeys(a for a, *_ in SHARD_CASES.values()):
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=SHARD_LAYERS[arch])
        params = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(SEED), "cuda")
        _same_on_ranks(tree_leaves(params), f"{arch} weights")
        for case, (a, *_) in SHARD_CASES.items():
            if a == arch:
                out[case] = _sharded_case(case, cfg, params, rules, rank,
                                          world)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _over_experts(n):
    return "" if n is None else f" over {n} experts"


def sharded_phase():
    """Two ranks decode the full-width models with the KV pool (and
    phi-tiny-moe's experts) sharded over them: over NCCL on two cards
    where there are two, else over gloo on the one card (NCCL refuses two
    ranks on one device; gloo takes the CUDA tensors and stages them
    through the host).  The parent's card memory is
    freed first.  Prints each rank's numbers; returns ({path: launches},
    {case: [each rank's numbers]})."""
    gc.collect()
    torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    where = "two cards" if backend == "nccl" else \
        "one card; gloo stages each collective's operands through the host"
    print(f"sharded decode: 2 ranks on the mesh (data 1, model 2) over "
          f"{backend} ({where})")
    t0 = time.perf_counter()
    ranks = launch(sharded_rank, 2, (backend,), backend=backend,
                   timeout=900)
    print(f"sharded decode: {time.perf_counter() - t0:.1f} s, the ranks' "
          f"start included")
    paths, numbers = {}, {}
    for case in SHARD_CASES:
        numbers[case] = [dict(r[case], transport=backend) for r in ranks]
        for rank, n in enumerate(numbers[case]):
            paths[f"{case} sharded, rank {rank}"] = n["launches"]
            print(f"{case} sharded, rank {rank}: {n['layers']} of "
                  f"{get_config(SHARD_CASES[case][0]).num_layers} layers "
                  f"(cut for the run's time, SHARD_LAYERS); "
                  f"{n['slots_here']} of "
                  f"{n['slots']} slots ({n['owned_here']} owned), rows at "
                  f"{n['positions']}; {n['steps']} steps: K1 "
                  f"{n['launches']['paged_decode_partials']}, K7 "
                  f"{n['launches']['moe_ffn']} launches"
                  f"{_over_experts(n['experts_here'])}; "
                  f"logits max |sharded - unsharded| {n['max_abs_err']:.4g} "
                  f"(tolerance {SHARD_LOGIT_TOL}); argmax differs at near "
                  f"ties {n['near_ties']} ({n['decided']} of "
                  f"{n['vectors']} decided); appended kv max |diff| "
                  f"{n['kv_max_abs_err']:.4g} (tolerance {SHARD_KV_TOL}), "
                  f"the rest bit for bit; logits apart by step "
                  f"{n['step_max_abs_err']}")
            if n["max_abs_err_own_routing"] is not None:
                print(f"{case} sharded, rank {rank}: routed by itself, its "
                      f"logits {n['max_abs_err_own_routing']:.4g} from the "
                      f"unsharded step's; rows it routed to other experts "
                      f"(step, MoE layer, row, gap log p_k/p_k+1) "
                      f"{n['rerouted']}; the numbers above from the steps "
                      f"replayed under the unsharded routing")
            print(f"{case} sharded, rank {rank}: step loop {n['sharded_loop_ms']:.2f} "
                  f"ms sharded, {n['unsharded_loop_ms']:.2f} unsharded; "
                  f"profiled step {n['wall_ms']:.2f} ms wall, "
                  f"{n['busy_ms']:.3f} ms device-busy (K1 {n['k1_ms']:.3f}, "
                  f"K7 {n['k7_ms']:.3f}, copies {n['memcpy_ms']:.3f}, NCCL "
                  f"{n['nccl_ms']:.3f}); {n['collectives_per_step']} "
                  f"collectives a step, {n['collectives_ms']:.2f} ms host "
                  f"({100 * n['collectives_share']:.1f}% of the wall); "
                  f"largest rows {n['top']}")
            print(f"{case} sharded, rank {rank}: tensor parallelism over "
                  f"model: {n['param_bytes_here'] / 2 ** 30:.3f} GiB of "
                  f"parameters held against the whole model's "
                  f"{n['param_bytes_whole'] / 2 ** 30:.3f}; its "
                  f"collectives {n['tp_collectives_per_step']} a step, "
                  f"{n['tp_collectives_ms']:.2f} ms host a step (the step "
                  f"loop's)")
    problems = [(case, rank, p) for case, ns in numbers.items()
                for rank, n in enumerate(ns) for p in n.pop("problems")]
    assert not problems, problems
    return paths, numbers


#: the sharded training phase's mesh: FSDP over ``data``, experts over
#: ``model``; four ranks share the one card over gloo (NCCL refuses two
#: ranks on one device), or take a card each over NCCL where there are four
TRAIN_MESH = ((2, 2), ("data", "model"))
#: full-width phi-tiny-moe's global batch on that mesh: one row of
#: synthetic tokens for each data index, the steps timed, then one step
#: profiled on every rank at once.  Cut to fit the card, in the order the
#: sequence, then the depth: at 2 x 8,192 tokens and all 32 layers a
#: rank's backward stopped at 16.41 GiB allocated (1.47 GiB more reserved),
#: and at 2 x 4,096 at 16.39 (1.48), the four ranks then holding 78.66 of
#: the card's 79.18 GiB (expandable segments on; measured on an H100
#: 80GB HBM3); a rank's state is 13.16 GB at 32 layers, 10.09 at 24.
#: Then cut to 12 layers for the run's time: the ranks talk over gloo on
#: the one card, 92-97% of a step in its collectives (24 layers 17-25 s a
#: step, 12 layers 12.1-16.6 s), and the whole run must end within
#: 1,200 s on machines that ran the same work up to 1.4x slower from one
#: call to the next (an H100 80GB HBM3, 700 W).  Not 6: there step 0's
#: nll read 0.0109 from the unsharded one, past ``SHARDED_LOSS_TOL``, for
#: the drops each data shard makes by design (0.0039 at 24 layers, 0.0064
#: at 12).  Its timed steps cut from 3 to 2 for the same reason.  Then,
#: to pay for tensor parallelism's collectives, from 12 to 10 layers and
#: to one step, timed and profiled at once: a whole run took 883 s against
#: 820, its four gloo ranks' phase 247.1 s, phi-tiny-moe's 12-layer steps
#: 22.0 and 26.9 s beside a 20.9 s lossless pass (an H100 80GB HBM3,
#: 700 W); step 0's nll gap, about 0.0016 + 0.056 / layers over the
#: depths above, reads about 0.0072 at 10
SHARDED_ROWS, SHARDED_SEQ, SHARDED_STEPS = 2, 4096, 1
SHARDED_LAYERS = 10
#: the row and the depth that the cuts left
SHARDED_SEQ_FULL = 8192


def _sharded_cfg():
    """phi-tiny-moe at full width and ``SHARDED_LAYERS`` of its layers."""
    return dataclasses.replace(get_config(PHI_TINY),
                               num_layers=SHARDED_LAYERS)


def _sharded_cut(cfg) -> str:
    """The cuts of the sharded training path, as its lines name them."""
    full = get_config(PHI_TINY)
    return (f"cut: the row {SHARDED_SEQ_FULL} -> {SHARDED_SEQ} tokens and "
            f"the depth {full.num_layers} -> 24 layers, four ranks did not "
            f"fit the card uncut; then the depth 24 -> {cfg.num_layers} "
            f"layers for the run's time")


#: largest |sharded - unsharded| of step 0's nll, and of its loss less
#: the weighted load-balance term, the unsharded ``loss_fn`` of the same
#: weights and rows run without grad after the ranks end: each data shard
#: fills its own experts' capacity (1.25 x its row's share) and so drops
#: other (token, expert) pairs than the global dispatch over both rows,
#: and the sum over ``model`` rounds once where one rank's combine rounds
#: add by add; a thousandth of a loss near ln(32,064) = 10.4.  The
#: load-balance term itself differs by design (each data shard's over its
#: own row, JAX's ``aux[None] / dsize``; rows that favour different
#: experts raise it: 67.21 against 50.79 as measured on an H100 80GB
#: HBM3) and is printed beside the unsharded one
SHARDED_LOSS_TOL = 1e-2
#: largest |sharded - unsharded| / unsharded of the global gradient norm
#: of step 0's weights and rows without what differs by design: the
#: load-balance term left out and every expert's capacity its rows'
#: (no pair dropped), so only the roundings part the two (the sum over
#: ``model`` rounds once, bf16 gradients summed over ``data`` in f32);
#: with both kept the norms stand 0.119 apart (16.896 against 15.096 as
#: measured on an H100 80GB HBM3), each data shard's load balance over
#: its own row and its own drops
SHARDED_GNORM_REL = 1e-2


def _without_design_gaps(cfg):
    """``cfg`` with the load-balance term out and each expert's capacity
    all of its rows' choices (``num_experts / top_k``): what sharded and
    unsharded steps compute alike."""
    mc = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, lb_loss_weight=0.0, capacity_factor=mc.num_experts / mc.top_k))


def _loss_and_grad_norm(params, batch, cfg, rules=None):
    """``loss_fn``'s loss, nll and aux at ``params`` on ``batch`` and the
    global norm of its gradient, as ``train_step`` takes it (on a mesh:
    this rank's shards, the gradients summed and the norm over the
    shards), nothing updated."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, m = M.loss_fn(params, batch, cfg, rules)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if rules is None:
        gnorm = _global_norm(tree_unflatten(params, grads))
    else:
        specs = _spec_leaves(M.param_specs(cfg, rules))
        gnorm = _sharded_norm(_sync_grads(grads, specs, rules), specs, rules)
    # on a mesh ``loss`` is this rank's share and ``m`` holds the sum
    return dict(loss=float(m.get("loss", loss).detach()),
                nll=float(m["nll"]), aux=float(m["aux"]),
                grad_norm=float(gnorm))


def _shard_reckoning(cfg, rules):
    """(parameters a rank holds, its bytes of parameters, gradients and
    AdamW moments) from ``abstract_params(cfg, rules)``, the rank's
    blocks, nothing allocated."""
    ap = tree_leaves(M.abstract_params(cfg, rules))
    return (sum(t.numel() for t in ap),
            sum(t.numel() * (2 * t.element_size() + 8) for t in ap))


def _sharded_full_width(rules, rank, world):
    """phi-tiny-moe at full width (``_sharded_cfg``) on this rank: its
    shard drawn from the seed
    (``init_params(..., rules)``), ``SHARDED_STEPS`` steps of the global
    batch timed (the ranks start each together), the last of them under
    the profiler on every rank at once, the launch counts set to 0 just
    before them and read just after, the whole leaves checked equal
    across the ranks after each step.  Returns its numbers."""
    cfg = _sharded_cfg()
    n_here, state = _shard_reckoning(cfg, rules)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    print(f"sharded training, rank {rank}: {before / 2 ** 30:.3f} GiB "
          f"allocated before the weights", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda", rules=rules)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    held_params = _tree_bytes(params)
    specs = _spec_leaves(M.param_specs(cfg, rules))
    batches = make_batches(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                           seed=SEED), SHARDED_ROWS,
                           SHARDED_SEQ)

    def next_batch():
        return {k: torch.from_numpy(v).cuda()
                for k, v in next(batches).items()}

    steps = [next_batch() for _ in range(SHARDED_STEPS)]
    # step 0's weights and rows without the gaps by design, for the
    # unsharded run the parent makes after the ranks end
    t0 = time.perf_counter()
    alike = _loss_and_grad_norm(params, steps[0], _without_design_gaps(cfg),
                                rules)
    print(f"sharded training, rank {rank}: step 0's gradient norm without "
          f"the gaps by design {alike['grad_norm']:.6f}, "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    # the peak the dry run predicts is the step's: taken from here (that
    # pass's lossless capacity dispatches more rows than a step's)
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    walls, hist, coll = [], [], []
    prof = None
    for step in range(SHARDED_STEPS):
        b = steps[step]
        cur_lr = cosine_lr(step, base=3e-4, warmup=100, total=1000)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        collectives.reset_stats()
        out = []

        def one(b=b, lr=cur_lr):
            t0 = time.perf_counter()
            out.append(train_step(params, opt, b, cfg, rules, lr=lr))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        # the last step runs under the profiler on every rank at once
        if step == SHARDED_STEPS - 1:
            prof = profiled(one, 1)
        else:
            one()
        params, opt, m = out[0]
        coll.append((collectives.stats["calls"],
                     collectives.stats["seconds"], *_tp_tagged()))
        vals = {k: float(v) for k, v in m.items()}
        print(f"sharded training, rank {rank}: step {step} "
              f"{walls[-1]:.1f} s, loss {vals['loss']:.5f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
              file=sys.stderr, flush=True)
        assert all(np.isfinite(list(vals.values()))), vals
        hist.append(vals)
        _same_on_ranks([t for t, spec in zip(tree_leaves(params), specs)
                        if not any(spec)], f"whole leaves after step {step}")
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    expect = expected_training_launches(cfg, SHARDED_STEPS)
    problems = [] if launches == expect else \
        [f"launches {launches}, predicted {expect}"]
    peak = torch.cuda.max_memory_allocated()
    rows = device_rows(prof, 1)
    busy = sum(ms for _, ms in rows)
    if not busy:
        problems.append("the profiled step's trace holds no device row")
    split = {"k4_forward_ms": ("flash_prefill",), "k4_backward_ms":
             ("flash_bwd",), "k7_forward_ms": ("moe_train_", "moe_pad_rows"),
             "k7_backward_ms": ("moe_bwd_",)}
    parts = {k: sum(ms for n, ms in rows if any(w in n for w in v))
             for k, v in split.items()}
    steady = float(np.mean(walls[1:] or walls))
    del params, opt, steps, prof
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        seq_len=SHARDED_SEQ, rows=SHARDED_ROWS, steps=SHARDED_STEPS,
        params_here=n_here, state_gb=state / 1e9, held_gib=held / 2 ** 30,
        init_s=init_s, step_ms=[w * 1e3 for w in walls],
        steady_step_ms=steady * 1e3,
        tokens_per_s=SHARDED_ROWS * SHARDED_SEQ / steady,
        peak_gib=peak / 2 ** 30, launches=launches,
        collectives_per_step=[c[0] for c in coll],
        collectives_ms=[c[1] * 1e3 for c in coll],
        collectives_share=[c[1] / w for c, w in zip(coll, walls)],
        tp_collectives_per_step=[c[2] for c in coll],
        tp_collectives_ms=[c[3] for c in coll],
        param_bytes_here=held_params,
        param_bytes_whole=_tree_bytes(M.abstract_params(cfg)),
        device_busy_ms=busy, busy_share=busy / (steady * 1e3), **parts,
        top=[(n[:60], round(ms, 3)) for n, ms in rows[:6]],
        losses=[h["loss"] for h in hist], nll=[h["nll"] for h in hist],
        aux=[h["aux"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist], step0_alike=alike,
        problems=problems)


#: the checkpoint check's model: phi-tiny-moe at full width and this many
#: layers (a stack of layers to move in pieces), its moments made from its
#: weights; cut from 2 to 1 for the run's time (saved in 18.3 s and
#: restored in 21.6 s at 2 in a run of 883 s, an H100 80GB HBM3, 700 W)
CKPT_LAYERS = 1


def _sharded_checkpoint(rules, rank, path):
    """``save_checkpoint`` of this rank's shards of phi-tiny-moe at full
    width and ``CKPT_LAYERS`` layers (the weights drawn from the seed, mu
    and nu made from them) to ``path``: every rank gathers, rank 0 writes,
    and no rank's device may grow by half the whole tree's bytes (the old
    gather kept every whole leaf on every rank); then every rank restores
    it into its shards' templates, bit for bit what it saved.  Returns its
    line."""
    cfg = dataclasses.replace(get_config(PHI_TINY), num_layers=CKPT_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED + 1), "cuda", rules=rules)
    leaves = tree_leaves(params)
    opt = adamw_init(params)._replace(
        mu=tree_unflatten(params, [t.float() * 0.5 for t in leaves]),
        nu=tree_unflatten(params, [t.float() ** 2 for t in leaves]))
    whole = sum(t.numel() * (t.element_size() + 8)
                for t in tree_leaves(M.abstract_params(cfg)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    save_checkpoint(path, params, opt, 1, cfg=cfg, rules=rules)
    torch.distributed.barrier()
    save_s = time.perf_counter() - t0
    grew = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    got, got_opt, step = restore_checkpoint(path, params, opt, cfg=cfg,
                                            rules=rules)
    load_s = time.perf_counter() - t0
    same = step == 1 and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(got) + tree_leaves(got_opt.mu)
            + tree_leaves(got_opt.nu),
            leaves + tree_leaves(opt.mu) + tree_leaves(opt.nu)))
    line = (f"{PHI_TINY} sharded checkpoint, rank {rank}: full width, "
            f"{CKPT_LAYERS} layers, {whole / 1e9:.2f} GB whole (weights "
            f"and moments); saved in {save_s:.1f} s (gathered in pieces, "
            f"rank 0 writing) with this rank's device grown "
            f"{grew / 2 ** 20:.1f} MiB at most; restored re-sharded in "
            f"{load_s:.1f} s, bit for bit what it saved: {same}")
    assert same, line
    assert grew < whole / 2, line
    del params, opt, got, got_opt, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return line


def sharded_train_rank(rank, world, backend, ckpt_path):
    """One rank of the sharded training phase (run by ``launch``): its card
    (its own with NCCL, the one card with gloo), the mesh and rules; the
    reduced models trained on the card and on the CPU over this mesh and
    held to each other (``check_reduced_training``), then full-width
    phi-tiny-moe, then a checkpoint of its shards at ``CKPT_LAYERS``
    layers saved to ``ckpt_path`` and restored (``_sharded_checkpoint``),
    then the recurrent families on the same mesh (``_recurrent_parts``).
    Returns (the reduced checks' and the checkpoint's lines, the
    full-width numbers, the recurrent families' numbers).  The rank's allocator maps its blocks in expandable
    segments: four ranks share the card's 80 GB, and each rank's cached
    but unallocated blocks (2.60 GiB at full width in a run without)
    would be the others' want."""
    # read when the rank's allocator starts, at its first CUDA call
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_num_threads(2)
    rules = make_rules(Mesh(*TRAIN_MESH))
    lines = []
    # reduced phi-tiny-moe (4 experts, 2 a rank) and yi-6b (dense: data
    # parallel and FSDP only); f32 over two steps, bf16 an MoE model's step
    # by step (its router's near ties)
    t0 = time.perf_counter()
    for arch in (PHI_TINY, "yi-6b"):
        for dtype in (torch.float32, torch.bfloat16):
            lines.append(check_reduced_training(arch, dtype, rules=rules))
    print(f"sharded training, rank {rank}: the reduced models held, "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    numbers = _sharded_full_width(rules, rank, world)
    lines.append(_sharded_checkpoint(rules, rank, ckpt_path))
    t0 = time.perf_counter()
    recurrent = _recurrent_parts(rules, rank, world)
    print(f"sharded training, rank {rank}: the recurrent families "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return lines, numbers, recurrent


def sharded_training_phase():
    """Four ranks train phi-tiny-moe at full width (``_sharded_cfg``: its
    depth and row cut to fit) on the mesh (data 2, model 2), after the
    reduced models trained on the card and on the CPU over the same mesh,
    and before a checkpoint of their shards saved and restored and the
    recurrent families' part (``_recurrent_parts``, its dry run counted on
    the host meanwhile); then the unsharded ``train_step`` of the same
    weights and step 0's rows against step 0's sharded loss and
    grad_norm.  Prints each rank's numbers; returns ({path: launches},
    [each rank's numbers], [each rank's recurrent numbers], the recurrent
    dry run's counts)."""
    gc.collect()
    torch.cuda.empty_cache()
    n = TRAIN_MESH[0][0] * TRAIN_MESH[0][1]
    backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    where = f"{n} cards" if backend == "nccl" else \
        "one card; gloo stages each collective's operands through the host"
    cfg = _sharded_cfg()
    print(f"sharded training: {n} ranks on the mesh (data 2, model 2) over "
          f"{backend} ({where}); {PHI_TINY} at full width and "
          f"{cfg.num_layers} layers "
          f"({M.param_count(M.abstract_params(cfg)) / 1e9:.3f} B), "
          f"{SHARDED_ROWS} x {SHARDED_SEQ} tokens a step "
          f"({_sharded_cut(cfg)}); the parent holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB")
    t0 = time.perf_counter()
    # the dry run of the recurrent families' steps, counted on the host
    # while the ranks run
    dry = {}

    def count():
        try:
            dry["counted"] = _count_recurrent()
        except BaseException as e:     # noqa: BLE001 -- re-raised below
            dry["error"] = e

    counting = threading.Thread(target=count)
    counting.start()
    ckpt_dir = tempfile.mkdtemp(prefix="sharded_ckpt_")
    try:
        ranks = launch(sharded_train_rank, n,
                       (backend, os.path.join(ckpt_dir, "ckpt.npz")),
                       backend=backend, timeout=1000)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        counting.join()
    print(f"sharded training: {time.perf_counter() - t0:.1f} s, the ranks' "
          f"start and the recurrent families included; the dry run of the "
          f"latter counted meanwhile")
    if "error" in dry:
        raise dry["error"]
    paths, numbers = {}, []
    for rank, (lines, nums, _) in enumerate(ranks):
        for line in lines:
            print(line)
        numbers.append(dict(nums, transport=backend))
        paths[f"{PHI_TINY} sharded training, rank {rank}"] = nums["launches"]
        per = {k: v // nums["steps"] for k, v in nums["launches"].items()
               if v}
        shares = nums["collectives_share"]
        print(f"{PHI_TINY} sharded training, rank {rank}: "
              f"{nums['params_here'] / 1e9:.3f} B parameters held, state "
              f"reckoned {nums['state_gb']:.2f} GB before allocating "
              f"({nums['held_gib']:.2f} GiB on the card after init, "
              f"{nums['init_s']:.1f} s); {nums['rows']} x {nums['seq_len']} "
              f"tokens a step, {cfg.num_layers} layers ({_sharded_cut(cfg)})"
              f"; step walls "
              f"{[round(w, 1) for w in nums['step_ms']]} ms, "
              f"{nums['tokens_per_s']:.0f} tokens/s (global, steps "
              f"{min(1, nums['steps'] - 1)}-{nums['steps'] - 1}); peak memory {nums['peak_gib']:.2f} GiB; "
              f"collectives a step {nums['collectives_per_step']}, host ms "
              f"{[round(c, 1) for c in nums['collectives_ms']]} "
              f"({', '.join(f'{100 * c:.1f}%' for c in shares)} of the "
              f"wall); launches a step {per} (K4 "
              f"{2 * cfg.num_layers} + {cfg.num_layers}, K7 "
              f"{2 * cfg.num_moe_layers} + {cfg.num_moe_layers} predicted); "
              f"one step profiled: "
              f"{nums['device_busy_ms']:.1f} ms device-busy "
              f"({100 * nums['busy_share']:.1f}% of the mean step wall), K4 "
              f"forward {nums['k4_forward_ms']:.1f}, backward "
              f"{nums['k4_backward_ms']:.1f}, K7 forward "
              f"{nums['k7_forward_ms']:.1f}, backward "
              f"{nums['k7_backward_ms']:.1f} ms; tensor parallelism over "
              f"model: {nums['param_bytes_here'] / 2 ** 30:.3f} GiB of "
              f"parameters held against the whole model's "
              f"{nums['param_bytes_whole'] / 2 ** 30:.3f}, its collectives "
              f"{nums['tp_collectives_per_step']} a step, host ms "
              f"{[round(c, 1) for c in nums['tp_collectives_ms']]}; losses "
              f"{[round(x, 5) for x in nums['losses']]}, nll "
              f"{[round(x, 5) for x in nums['nll']]}, aux "
              f"{[round(x, 5) for x in nums['aux']]}, grad_norm "
              f"{[round(x, 5) for x in nums['grad_norms']]}; largest rows "
              f"{nums['top']}")
    problems = [(rank, p) for rank, n_ in enumerate(numbers)
                for p in n_.pop("problems")]
    assert not problems, problems
    assert all(n_["losses"] == numbers[0]["losses"] for n_ in numbers)
    # step 0 against the unsharded loss and gradient of the same weights
    # and rows, as trained and without the gaps by design
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda")
    b = {k: torch.from_numpy(v).cuda() for k, v in next(make_batches(
        SyntheticCorpus(vocab_size=cfg.vocab_size, seed=SEED), SHARDED_ROWS,
        SHARDED_SEQ)).items()}
    ref = _loss_and_grad_norm(params, b, cfg)
    ref_alike = _loss_and_grad_norm(params, b, _without_design_gaps(cfg))
    got = dict(loss=numbers[0]["losses"][0], nll=numbers[0]["nll"][0],
               aux=numbers[0]["aux"][0],
               grad_norm=numbers[0]["grad_norms"][0])
    alike = numbers[0]["step0_alike"]
    assert all(n_["step0_alike"] == alike for n_ in numbers)
    w = cfg.moe.lb_loss_weight
    apart = dict(nll=abs(got["nll"] - ref["nll"]),
                 loss_less_lb=abs((got["loss"] - w * got["aux"])
                                  - (ref["loss"] - w * ref["aux"])),
                 nll_alike=abs(alike["nll"] - ref_alike["nll"]))
    gnorm_rel = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    alike_rel = (abs(alike["grad_norm"] - ref_alike["grad_norm"])
                 / ref_alike["grad_norm"])
    print(f"{PHI_TINY} sharded training: step 0 sharded / unsharded (the "
          f"same weights and rows; the unsharded on the card after the "
          f"ranks end): loss {got['loss']:.5f} / {ref['loss']:.5f}, nll "
          f"{got['nll']:.5f} / {ref['nll']:.5f}, aux {got['aux']:.5f} / "
          f"{ref['aux']:.5f} (each data shard's, by design; weight {w}), "
          f"grad_norm {got['grad_norm']:.6f} / {ref['grad_norm']:.6f} "
          f"({gnorm_rel:.3g} apart: each shard's load balance and drops); "
          f"without the load-balance term and at capacity factor "
          f"{cfg.moe.num_experts / cfg.moe.top_k} (no drop): nll "
          f"{alike['nll']:.5f} / {ref_alike['nll']:.5f}, grad_norm "
          f"{alike['grad_norm']:.6f} / {ref_alike['grad_norm']:.6f}, "
          f"{alike_rel:.3g} apart (tolerance {SHARDED_GNORM_REL}); apart "
          f"{apart} (tolerance {SHARDED_LOSS_TOL})")
    assert all(v <= SHARDED_LOSS_TOL for v in apart.values()), apart
    assert alike_rel <= SHARDED_GNORM_REL, (alike, ref_alike)
    for n_ in numbers:
        n_["unsharded_step0"] = ref
        n_["unsharded_step0_alike"] = ref_alike
    del params, b
    gc.collect()
    torch.cuda.empty_cache()
    return paths, numbers, [r[2] for r in ranks], dry["counted"]


# ---------------------------------------------------------------------------
# the recurrent families on a mesh: four ranks on (data 2, model 2)
# ---------------------------------------------------------------------------

#: the recurrent families' mesh: the batch and its states over ``data``,
#: FSDP over ``data`` in training and prefill, zamba2's KV slots over both
#: axes; four ranks share the one card over gloo, or take a card each
RECURRENT_MESH = TRAIN_MESH
#: decode: SHARD_CASES' rows (positions 41, 24, 33, 17; two a data index)
#: over zamba2's 24 slots of 8, from the states and KV of an unsharded
#: prefill of each row alone, SHARD_STEPS steps sharded and unsharded
RECURRENT_POS, RECURRENT_BS, RECURRENT_SLOTS = (41, 24, 33, 17), 8, 24
#: largest |sharded - unsharded| entry of a rank's recurrent states after
#: the steps, over that leaf's largest entry.  The sharded step multiplies
#: two rows where the unsharded one multiplies four, cuBLAS picks another
#: algorithm for each, and the bf16 roundings that differ carry through
#: the layers and the steps.  Measured on an H100 80GB HBM3 (700 W), the
#: same in six runs with the recurrent layers whole on every rank:
#: zamba2-7b 0.02927 (rows 0-1) and 0.04683 (rows 2-3), xlstm-1.3b 0 and
#: 0.04885; with the layers split by heads over ``model``, zamba2-7b
#: 0.02174-0.04857.  The bound is the power of two above the largest.  A
#: rank holding another data index's rows, or another ``model`` index's
#: heads, reads far above it (``wrong_cut_rel``, ``wrong_heads_rel``,
#: printed beside it and held above the bound)
RECURRENT_STATE_REL = 2.0 ** -4
#: zamba2-7b's prefill on the mesh: 4 rows of 1,024 tokens (two a data
#: index), held to the unsharded prefill of the same weights and rows:
#: each rank's rows of the last logits, the KV and the final states.  Its
#: depth cut from 81 to 15 layers (two super-blocks and a tail of three,
#: as at 81) for the run's time: at 81 layers its 83 all-gathers over gloo
#: took 14.3-14.7 s of a 15.7-16.1 s prefill (an H100 80GB HBM3, 700 W),
#: and the weights' bytes follow the depth
RECURRENT_PREFILL_ROWS, RECURRENT_PREFILL_SEQ = 4, 1024
RECURRENT_PREFILL_LAYERS = 15
#: largest |sharded - unsharded| of those, over each tensor's largest
#: entry, with tensor parallelism over ``model`` (the default rules), as
#: zamba2-7b's decode states are held (``RECURRENT_STATE_REL``): the
#: row-parallel products are summed over the ranks in another order than
#: one product's, so a few of their bf16 roundings fall the other way,
#: and the Mamba2 layers after carry them (measured at 15 layers on an
#: H100 80GB HBM3, 700 W: 0.0089-0.0204 of a tensor's largest entry with
#: the shared block alone tensor-parallel, 0.0174-0.0292 with the Mamba2
#: layers split by heads too; without tensor parallelism the prefill came
#: bit for bit and was held at 2^-6)
RECURRENT_PREFILL_TP_REL = 2.0 ** -4
#: training on the mesh: 2 rows a step (one a data index), the steps
#: timed and one profiled; arch -> (layers, tokens a row).  Cuts, in the
#: order the sequence, then the depth, each reckoned with the dry run of
#: this mesh (rank 0 of four): zamba2-7b at 15 of its 81 layers (two
#: super-blocks of six Mamba2 layers and the shared block, and a tail of
#: three, as at 81 layers; 1.60 B parameters, 12.78 GiB a rank);
#: xlstm-1.3b's rows cut from 4,096 to 256 tokens: its sLSTM blocks run a
#: token at a time, some 120 ops a token and block forward and backward,
#: so the step's ops, and its host time over gloo, grow with the row (a
#: 16-layer step of 2 x 256 tokens took 13.9 s on an H100 80GB HBM3, 76%
#: of it in the host's side of the collectives), and the dry run counts
#: those ops on the host beside the ranks; then its depth from 48 to 40
#: layers (five of its six super-blocks of eight): at 48 a rank's peak is
#: 20.96 GiB, four 83.85 of the card's 79.18; at 40 15.76 GiB a rank;
#: then from 40 to 8 (one super-block: seven mLSTM blocks and the sLSTM
#: block) for the run's time: a 40-layer step took 18.7-22.1 s, 68-73% of
#: it in gloo's collectives, a 16-layer step 13.2-19.9 s (an H100 80GB
#: HBM3, 700 W).  For the same reason each family trains one step, timed
#: and profiled at once, not two timed and a third profiled: zamba2-7b's
#: second step took 14.4-24.8 s
#: zamba2-7b then from 15 to 8 layers for the run's time (one shared
#: block, tensor-parallel, at layer 6): its 15-layer step took 31.6 s with
#: tensor parallelism's collectives (an H100 80GB HBM3, 700 W)
RECURRENT_TRAIN = {XLSTM: (8, 256), ZAMBA2: (8, 4096)}
#: why each recurrent training path's depth was cut
RECURRENT_DEPTH_WHY = {
    XLSTM: "48 -> 40 layers: four ranks reckoned past the card uncut; 40 "
           "-> 8 for the run's time",
    ZAMBA2: "81 -> 15 layers: four ranks reckoned past the card uncut; "
            "15 -> 8 for the run's time"}
#: the recurrent families' decode on the mesh, cut for the run's time
#: (tensor parallelism's collectives: zamba2-7b's sharded step 824-866 ms
#: at 81 layers, an H100 80GB HBM3, 700 W): zamba2-7b to 21 layers (3 of
#: its 13 shared-block uses), xlstm-1.3b to 24 (3 of its 6 super-blocks)
RECURRENT_DECODE_LAYERS = {ZAMBA2: 21, XLSTM: 24}
#: the weights' dtype of each family's decode on the mesh.  xlstm-1.3b's
#: is f32: split by heads, each row-parallel product sums the ranks' f32
#: partials in another order than one product does, so in bf16 a few
#: roundings fall otherwise, and the mLSTM and sLSTM blocks' exponential
#: gates (``exp(i - m)``) carry them through 24 layers and 8 steps: in
#: bf16 its states read 0.1033-0.177 of a leaf's largest entry (an H100
#: 80GB HBM3, 700 W), past ``RECURRENT_STATE_REL``.  In f32 the split is
#: held to the unsharded decode at that bound with the roundings out of
#: the way; the bf16 split is held to JAX's sharded decode on the CPU
#: (tests/test_torch_recurrent_mesh.py)
RECURRENT_DECODE_DTYPE = {ZAMBA2: "bfloat16", XLSTM: "float32"}
RECURRENT_TRAIN_ROWS, RECURRENT_TRAIN_STEPS = 2, 1
RECURRENT_TRAIN_SEQ_FULL = 4096


def _recurrent_prefill_cfg():
    return dataclasses.replace(get_config(ZAMBA2),
                               num_layers=RECURRENT_PREFILL_LAYERS)


def _recurrent_decode_cfg(arch):
    return dataclasses.replace(get_config(arch),
                               num_layers=RECURRENT_DECODE_LAYERS[arch])


def _decode_weights(arch, params):
    """``params`` in the family's decode dtype (``RECURRENT_DECODE_DTYPE``):
    f32 widens every leaf (exactly: the same weights)."""
    if RECURRENT_DECODE_DTYPE[arch] == "bfloat16":
        return params
    return tree_unflatten(params, [t.float() for t in tree_leaves(params)])


def _recurrent_train_cfg(arch):
    return dataclasses.replace(get_config(arch),
                               num_layers=RECURRENT_TRAIN[arch][0])


def _recurrent_cut(arch) -> str:
    """The cuts of a recurrent family's training path, as its lines name
    them."""
    layers, seq = RECURRENT_TRAIN[arch]
    full = get_config(arch).num_layers
    cuts = []
    if seq < RECURRENT_TRAIN_SEQ_FULL:
        cuts.append(f"the row {RECURRENT_TRAIN_SEQ_FULL} -> {seq} tokens "
                    f"(its sLSTM blocks run a token at a time)")
    if layers < full:
        cuts.append(f"the depth {full} -> {layers} layers "
                    f"({RECURRENT_DEPTH_WHY[arch]})")
    return "cut: " + ("; ".join(cuts) if cuts else "none")


def _cat_rows(cfg, parts):
    """Per-row recurrent states (each of one row, the model's layout)
    joined along the batch dim, which follows two stack dims for the
    mLSTM states and one for the others."""
    if cfg.family == "hybrid":
        return type(parts[0])(*(torch.cat(t, dim=1) for t in zip(*parts)))
    m, s = zip(*parts)
    return (type(m[0])(*(torch.cat(t, dim=2) for t in zip(*m))),
            type(s[0])(*(torch.cat(t, dim=1) for t in zip(*s))))


def _state_leaves(cfg, states):
    """[(leaf, its batch dim)] of the model's recurrent states."""
    if cfg.family == "hybrid":
        return [(t, 1) for t in states]
    return [(t, 2) for t in states[0]] + [(t, 1) for t in states[1]]


def _next_model_index(rules):
    """``rules`` as the rank of the same data index and the next ``model``
    index sees them (its blocks of a leaf; no process group)."""
    mesh = rules.mesh
    coords = dict(mesh.coords, model=(mesh.coords["model"] + 1)
                  % mesh.shape["model"])
    rank = sum(coords[a] * math.prod(mesh.shape[b] for b in
                                     mesh.axis_names[i + 1:])
               for i, a in enumerate(mesh.axis_names))
    return dataclasses.replace(rules, mesh=Mesh(
        list(mesh.shape.values()), mesh.axis_names, rank=rank))


def _rank_states(cfg, states, rules, rows):
    """The leaves of whole recurrent states (every row and head) cut as
    this rank holds them (``M.state_specs``: its heads where the layers
    split them, the conv tails its channels), at the batch rows
    ``rows``."""
    specs = M.state_specs(cfg, rules, _state_leaves(cfg, states)[0][0]
                          .shape[1 if cfg.family == "hybrid" else 2])
    spec_leaves = list(specs) if cfg.family == "hybrid" else \
        list(specs[0]) + list(specs[1])
    out = []
    for (t, dim), spec in zip(_state_leaves(cfg, states), spec_leaves):
        index = list(shard_slices(rules, spec, t.shape))
        index[dim] = rows
        out.append(t[tuple(index)])
    return out


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _other_rows(rows, b):
    """The rows of the next data index after ``rows`` (a slice of ``b``):
    what a rank whose cut went wrong would hold; None where ``rows`` is
    every row."""
    k = rows.stop - rows.start
    return None if k == b else slice((rows.start + k) % b,
                                     (rows.start + k) % b + k)


def _recurrent_decode(arch, cfg, params, rules, rank, world):
    """One recurrent family's decode on this rank: each row of
    ``RECURRENT_POS`` prefilled alone (unsharded, a prompt of random
    tokens) for its states and, for zamba2, its KV (written into a pool of
    ``RECURRENT_SLOTS`` slots dealt from a seed, the same on every rank);
    ``SHARD_STEPS`` unsharded steps from the prefills' argmax, each fed the
    last step's, then the same steps sharded (``bridge.shard_decode``: the
    rank's slots, its rows and heads of the states and its heads of the
    recurrent layers' leaves), fed the unsharded tokens,
    the launch counts set to 0 just before them and read just after.
    Held: the rank's rows' logits within ``SHARD_LOGIT_TOL``, argmax equal
    but for near ties, the tokens returned whole, the appended KV within
    ``SHARD_KV_TOL`` (the rest bit for bit), the rank's states (its rows
    and heads) within ``RECURRENT_STATE_REL``, K1 once a KV layer a step.
    Then two sharded steps timed and one profiled on every rank at once.
    Returns its numbers."""
    pos, bs = RECURRENT_POS, RECURRENT_BS
    b, L = len(pos), M.num_kv_layers(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    prompt = torch.randint(3, cfg.vocab_size, (b, max(pos)), generator=gen,
                           device="cuda", dtype=torch.int32)
    firsts, parts, kvs = [], [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for r, p in enumerate(pos):
            last, out = M.prefill(params, {
                "tokens": prompt[r:r + 1, :p],
                "positions": torch.arange(p, device="cuda",
                                          dtype=torch.int32)[None]}, cfg)
            firsts.append(torch.argmax(last, -1).to(torch.int32))
            parts.append(out.states)
            kvs.append(out.kv)
    states = _cat_rows(cfg, parts)
    del parts
    print(f"{arch} sharded decode, rank {rank}: the rows' prefills "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    q0 = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kv = where = None
    if L:
        def fill(pk, pv, where):
            for r, p in enumerate(pos):
                for j in range(-(-p // bs)):
                    n, s = min(bs, p - j * bs), where[(r, j)]
                    pk[:, s, :n] = kvs[r][0][:, 0, j * bs:j * bs + n].float()
                    pv[:, s, :n] = kvs[r][1][:, 0, j * bs:j * bs + n].float()

        kv, _, _, where = deal_pools(
            L, pos, bs, cfg.num_kv_heads, cfg.resolved_head_dim,
            lambda r, j: False, SEED + 17, steps=SHARD_STEPS, device="cuda",
            fill=fill, slots=RECURRENT_SLOTS)
        _same_on_ranks([kv.pool_k], "pools")
    del kvs
    full = M.DecodeState(tokens=torch.cat(firsts), pos=q0, kv=kv, peer=None,
                         states=states)
    p_r, st_r = shard_decode(params, full, cfg, rules)
    rows = batch_rows(rules, b)
    held = sum(t.numel() * t.element_size() for t in _tensors(st_r.states))
    whole = sum(t.numel() * t.element_size() for t in _tensors(states))

    def at(st, t, toks):
        st = st._replace(tokens=toks, pos=q0 + t)
        if L:
            p = [q + t for q in pos]
            st = st._replace(kv=st.kv._replace(
                append_slot=torch.tensor([where[(r, q // bs)] for r, q in
                                          enumerate(p)], dtype=torch.int32,
                                         device="cuda"),
                append_off=torch.tensor([q % bs for q in p],
                                        dtype=torch.int32, device="cuda")))
        return st

    st, ref, feed = full, [], [full.tokens]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SHARD_STEPS):
        lg, st = M.serve_step(params, at(st, t, feed[-1]), cfg)
        ref.append(lg.float())
        feed.append(st.tokens)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
    ref_states = st.states
    for fn in COUNTERS.values():
        fn.launches = 0
    collectives.reset_stats()
    st, got, whole_tokens = st_r, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SHARD_STEPS):
        lg, st = M.serve_step(p_r, at(st, t, feed[t]), cfg, rules=rules)
        got.append(lg.float())
        whole_tokens.append(st.tokens)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    coll_calls = collectives.stats["calls"] // SHARD_STEPS
    tp_calls, tp_ms = _tp_tagged()
    print(f"{arch} sharded decode, rank {rank}: tensor parallelism over "
          f"model: {_tree_bytes(p_r) / 2 ** 30:.3f} GiB of parameters held "
          f"against the whole model's {_tree_bytes(params) / 2 ** 30:.3f}, "
          f"of the recurrent layers' {_recurrent_gib(p_r):.3f} against "
          f"{_recurrent_gib(params):.3f}; "
          f"its collectives {tp_calls // SHARD_STEPS} a step, "
          f"{tp_ms / SHARD_STEPS:.2f} ms host a step", file=sys.stderr,
          flush=True)
    problems = []
    want_k1 = L * SHARD_STEPS
    if launches["paged_decode_partials"] != want_k1 or any(
            n for k, n in launches.items() if k != "paged_decode_partials"):
        problems.append(f"launches {launches}, K1 predicted {want_k1}")
    ref, got = torch.stack(ref)[:, rows], torch.stack(got)
    if got.shape != ref.shape or not torch.isfinite(got).all():
        problems.append(f"logits {tuple(got.shape)} against "
                        f"{tuple(ref.shape)}, or not finite")
    step_err = (ref - got).abs().amax(dim=(1, 2)).tolist()
    err = max(step_err)
    if err > SHARD_LOGIT_TOL:
        problems.append(f"logits {err} apart")
    d = (ref - got).abs().amax(-1)
    top = torch.topk(ref, 2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    decided = int((gap > 2 * d).sum())
    ties = [(tuple(ix), round(float(gap[tuple(ix)]), 5),
             round(float(d[tuple(ix)]), 5)) for ix in torch.nonzero(
                 torch.argmax(ref, -1) != torch.argmax(got, -1)).tolist()]
    if any(g > 2 * dd for _, g, dd in ties):
        problems.append(f"tokens differ past near ties: {ties}")
    # the tokens come back whole: the rank's rows its own argmax
    for t, toks in enumerate(whole_tokens):
        if toks.shape != (b,) or not torch.equal(
                toks[rows], torch.argmax(got[t], -1).to(torch.int32)):
            problems.append(f"step {t}'s tokens {toks.tolist()}")
    def state_gap(at):
        return max(_rel(g, w) for (g, _), w in zip(
            _state_leaves(cfg, st.states),
            _rank_states(cfg, ref_states, rules, at)))

    bound = RECURRENT_STATE_REL
    state_err = state_gap(rows)
    if state_err > bound:
        problems.append(f"states {state_err} apart")
    other = _other_rows(rows, b)
    wrong = None if other is None else state_gap(other)
    if wrong is not None and wrong <= bound:
        problems.append(f"another data index's rows read {wrong}: the "
                        f"bound cannot tell a wrong row cut")
    wrong_heads = max(_rel(g, w) for (g, _), w in zip(
        _state_leaves(cfg, st.states),
        _rank_states(cfg, ref_states, _next_model_index(rules), rows)))
    if wrong_heads <= bound:
        problems.append(f"another model index's heads read {wrong_heads}: "
                        f"the bound cannot tell a wrong head cut")
    kv_err = 0.0
    if L:
        n_loc = st.kv.slot_req.shape[0]
        lo = rules.mesh.axis_index(kv_block_axes(rules)) * n_loc
        appended = torch.zeros((n_loc, bs), dtype=torch.bool, device="cuda")
        for t in range(SHARD_STEPS):
            for r, q in enumerate(pos):
                s = where[(r, (q + t) // bs)] - lo
                if 0 <= s < n_loc:
                    appended[s, (q + t) % bs] = True
        for mine, whole_pool in ((st.kv.pool_k, full.kv.pool_k),
                                 (st.kv.pool_v, full.kv.pool_v)):
            whole_pool = whole_pool[:, lo:lo + n_loc]
            if not torch.equal(mine[:, ~appended], whole_pool[:, ~appended]):
                problems.append("a pool entry the steps did not write "
                                "differs")
            if appended.any():
                kv_err = max(kv_err, (mine[:, appended]
                                      - whole_pool[:, appended]).abs()
                             .max().item())
        if kv_err > SHARD_KV_TOL:
            problems.append(f"appended kv {kv_err} apart")
    last = at(st, SHARD_STEPS - 1, feed[SHARD_STEPS - 1])

    def step():
        lg, _ = M.serve_step(p_r, last, cfg, rules=rules)
        lg.float().cpu()        # the engine samples on the host

    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    collectives.reset_stats()
    t1 = time.perf_counter()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3 / 2
    coll_ms = collectives.stats["seconds"] * 1e3 / 2
    torch.distributed.barrier()
    prof_rows = device_rows(profiled(step, 1), 1)   # every rank at once
    if not any(ms > 0 for _, ms in prof_rows):
        problems.append("the profiled step's trace holds no device row")
    print(f"{arch} sharded decode, rank {rank}: step loops "
          f"{unsharded_ms:.1f} / {sharded_ms:.1f} ms a step unsharded / "
          f"sharded, the timed and profiled steps "
          f"{time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    busy = sum(ms for _, ms in prof_rows)
    k1 = sum(ms for n, ms in prof_rows if any(k in n for k in K1_KERNELS))
    return dict(positions=list(pos), rows=[rows.start, rows.stop],
                dtype=RECURRENT_DECODE_DTYPE[arch], steps=SHARD_STEPS,
                launches=launches,
                recurrent_gib_here=_recurrent_gib(p_r),
                recurrent_gib_whole=_recurrent_gib(params),
                states_mib_here=held / 2 ** 20,
                states_mib_whole=whole / 2 ** 20, max_abs_err=err,
                step_max_abs_err=[round(e, 5) for e in step_err],
                near_ties=ties, decided=decided, vectors=ref[..., 0].numel(),
                state_rel_err=state_err, state_bound=bound,
                wrong_cut_rel=wrong, wrong_heads_rel=wrong_heads,
                kv_max_abs_err=kv_err,
                problems=problems, sharded_loop_ms=sharded_ms,
                unsharded_loop_ms=unsharded_ms,
                collectives_per_step=coll_calls, wall_ms=wall, busy_ms=busy,
                k1_ms=k1, collectives_ms=coll_ms,
                collectives_share=coll_ms / wall,
                top=[(n[:50], round(ms, 4)) for n, ms in prof_rows[:4]])


def _recurrent_prefill(cfg, box, rules, rank):
    """zamba2-7b's prefill on the mesh: ``RECURRENT_PREFILL_ROWS`` rows of
    ``RECURRENT_PREFILL_SEQ`` random tokens, first unsharded over the whole
    weights that ``box`` holds alone (every row), then, the whole weights
    taken from it and freed, the
    rank's shard drawn from the same seed (``init_params(..., rules)``:
    its block of the same draws), ``prefill(..., rules)``, the launch
    counts set to 0 just before it and read just after, its peak taken
    from there.  Held: the rank's rows of the last logits, the KV and the
    final states within ``RECURRENT_PREFILL_TP_REL`` of each tensor's
    largest entry (the default rules, tensor-parallel over ``model``,
    whose launches, collectives and peak the dry run predicts); K4 once a
    KV layer.  The peak is the prefill's over what the
    rank held besides its arguments (the earlier parts' leftovers, the
    kernels' cached workspaces), as the dry run counts it.  Returns its
    numbers."""
    params = box.pop()
    b, s = RECURRENT_PREFILL_ROWS, RECURRENT_PREFILL_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "positions": torch.arange(s, device="cuda", dtype=torch.int32)
             .expand(b, s).contiguous()}
    rows = batch_rows(rules, b)
    other = _other_rows(rows, b)
    # one rank at a time: four ranks' whole weights and one unsharded
    # prefill's temporaries (8-9 GiB over the four rows) fit the card, four
    # prefills at once do not
    for who in range(torch.distributed.get_world_size()):
        if who == rank:
            with torch.no_grad():
                ref_last, ref_out = M.prefill(params, batch, cfg)
            def cut(at):
                # nothing of it on the card; the states as the rank
                # holds them (its heads, its conv channels)
                return [t.cpu() for t in [ref_last[at]] + [
                    t[:, at] for t in ref_out.kv] + _rank_states(
                        cfg, ref_out.states, rules, at)]

            ref = cut(rows)
            ref_wrong = None if other is None else cut(other)
            del ref_last, ref_out
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in batch.values())
    problems = []
    bound = RECURRENT_PREFILL_TP_REL
    shards = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda", rules=rules)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    collectives.reset_stats()
    t0 = time.perf_counter()
    last, out = M.prefill(shards, batch, cfg, rules)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    coll = (collectives.stats["calls"], collectives.stats["seconds"] * 1e3,
            *_tp_tagged())
    got = [last] + list(out.kv) + [t for t, _ in
                                   _state_leaves(cfg, out.states)]
    errs = [_rel(g.cpu(), w) if g.shape == w.shape else float("inf")
            for g, w in zip(got, ref)]
    if max(errs) > bound:
        problems.append(f"prefill: {errs} apart")
    # another data index's rows: the least of the tensors' readings, so
    # that each tensor's check could tell a wrong cut
    wrong = None if other is None else min(
        _rel(g.cpu(), w) for g, w in zip(got, ref_wrong))
    if wrong is not None and wrong <= bound:
        problems.append(f"prefill: another data index's rows read {wrong}: "
                        f"the bound cannot tell a wrong row cut")
    want_k4 = M.num_kv_layers(cfg)
    if launches["prefill_attention"] != want_k4 or any(
            n for k, n in launches.items() if k != "prefill_attention"):
        problems.append(f"prefill: launches {launches}, K4 predicted "
                        f"{want_k4}")
    del shards, last, out, got, ref, ref_wrong
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall_ms=wall, launches=launches, peak_gib=peak / 2 ** 30,
                collectives=coll[0], collectives_ms=coll[1],
                tp_collectives=coll[2], tp_collectives_ms=coll[3],
                bound=bound, rel_errs=[round(e, 6) for e in errs],
                wrong_cut_rel=wrong, rows=RECURRENT_PREFILL_ROWS,
                seq=RECURRENT_PREFILL_SEQ, layers=cfg.num_layers,
                rows_here=[rows.start, rows.stop], problems=problems)


def _differing_leaves(params, specs):
    """The paths of the leaves no axis splits whose bits differ across the
    ranks (each one's f32 sum and its largest |entry|, compared over the
    world), with the spread of their sums."""
    names = [k for k, spec in zip(_leaf_paths(params), specs)
             if not any(spec)]
    leaves = [t for t, spec in zip(tree_leaves(params), specs)
              if not any(spec)]
    fp = torch.stack([torch.stack([t.sum(dtype=torch.float32),
                                   t.abs().max().float()]) for t in leaves])
    hi, lo = fp.clone(), -fp
    collectives.all_reduce(hi, "max", None)
    collectives.all_reduce(lo, "max", None)
    off = ((hi != fp) | (-lo != fp)).any(-1)
    spread = (hi + lo)[:, 0]
    return [(names[i], float(spread[i])) for i in
            torch.nonzero(off).flatten().tolist()]


def _leaf_paths(tree, prefix=""):
    """``tree_leaves``' order of the leaves' paths."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    return [p for k in sorted(tree)
            for p in _leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k)]


def _recurrent_training(arch, rules, rank):
    """``arch`` trained on this rank (``_recurrent_train_cfg``: its cut
    depth; 2 rows of its cut sequence a step, one a data index): its shard
    drawn from the seed (``init_params(..., rules)``), the peak counted
    from there over what the rank held before (the earlier parts'
    leftovers, the kernels' cached workspaces, which the dry run does not
    count), ``RECURRENT_TRAIN_STEPS`` steps timed (the ranks start
    each together), the launch counts set to 0 just before them and read
    just after, the whole leaves checked equal across the ranks after
    each step, the last step run under the profiler on every rank at once
    (its wall then holds the profiler's cost).  Returns its numbers; step
    0's loss and grad_norm are held in the parent."""
    cfg = _recurrent_train_cfg(arch)
    seq = RECURRENT_TRAIN[arch][1]
    n_here, state = _shard_reckoning(cfg, rules)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda", rules=rules)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    recurrent_here = _recurrent_gib(params)
    specs = _spec_leaves(M.param_specs(cfg, rules))
    batches = make_batches(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                           seed=SEED),
                           RECURRENT_TRAIN_ROWS, seq)
    steps = [{k: torch.from_numpy(v).cuda() for k, v in next(batches)
              .items()} for _ in range(RECURRENT_TRAIN_STEPS)]
    for fn in COUNTERS.values():
        fn.launches = 0
    walls, hist, coll, problems = [], [], [], []
    prof = None
    for step in range(RECURRENT_TRAIN_STEPS):
        cur_lr = cosine_lr(step, base=3e-4, warmup=100, total=1000)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        collectives.reset_stats()
        out = []

        def one(step=step, lr=cur_lr):
            t0 = time.perf_counter()
            out.append(train_step(params, opt, steps[step], cfg, rules,
                                  lr=lr))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        # the last step runs under the profiler on every rank at once
        if step == RECURRENT_TRAIN_STEPS - 1:
            prof = profiled(one, 1)
        else:
            one()
        params, opt, m = out[0]
        coll.append((collectives.stats["calls"],
                     collectives.stats["seconds"]))
        tp_calls, tp_ms = _tp_tagged()
        vals = {k: float(v) for k, v in m.items()}
        print(f"{arch} sharded training, rank {rank}: step {step} "
              f"{walls[-1]:.1f} s, tensor parallelism's collectives "
              f"{tp_calls} ({tp_ms:.0f} ms host), parameters held "
              f"{_tree_bytes(params) / 2 ** 30:.3f} GiB against the whole "
              f"model's {_tree_bytes(M.abstract_params(cfg)) / 2 ** 30:.3f}"
              f" (the recurrent layers' {_recurrent_gib(params):.3f} "
              f"against {_recurrent_gib(M.abstract_params(cfg)):.3f})"
              f", loss {vals['loss']:.5f}, peak "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} "
              f"GiB over the {base / 2 ** 30:.3f} held before",
              file=sys.stderr, flush=True)
        hist.append(vals)
        differ = _differing_leaves(params, specs)
        if differ:
            problems.append(f"whole leaves after step {step} differ across "
                            f"the ranks: {differ}")
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    L = M.num_kv_layers(cfg) * RECURRENT_TRAIN_STEPS
    expect = dict({n: 0 for n in COUNTERS}, prefill_attention=2 * L,
                  prefill_attention_bwd=L)
    if launches != expect:
        problems.append(f"launches {launches}, predicted {expect}")
    if not all(np.isfinite(list(h.values())).all() for h in hist):
        problems.append(f"non-finite metrics {hist}")
    peak = torch.cuda.max_memory_allocated() - base
    rows = device_rows(prof, 1)
    busy = sum(ms for _, ms in rows)
    if not busy:
        problems.append("the profiled step's trace holds no device row")
    parts = {k: sum(ms for n, ms in rows if v in n) for k, v in (
        ("k4_forward_ms", "flash_prefill"), ("k4_backward_ms", "flash_bwd"),
        ("nccl_ms", "nccl"))}
    steady = float(np.mean(walls))
    del params, opt, steps, prof
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        layers=cfg.num_layers, seq_len=seq, rows=RECURRENT_TRAIN_ROWS,
        steps=RECURRENT_TRAIN_STEPS, params_here=n_here,
        recurrent_gib_here=recurrent_here,
        recurrent_gib_whole=_recurrent_gib(M.abstract_params(cfg)),
        state_gb=state / 1e9, held_gib=held / 2 ** 30, init_s=init_s,
        step_ms=[w * 1e3 for w in walls], steady_step_ms=steady * 1e3,
        tokens_per_s=RECURRENT_TRAIN_ROWS * seq / steady,
        peak_gib=peak / 2 ** 30, held_before_gib=base / 2 ** 30,
        launches=launches, collectives_per_step=[c for c, _ in coll],
        collectives_ms=[sec * 1e3 for _, sec in coll],
        collectives_share=[sec / w for (_, sec), w in zip(coll, walls)],
        device_busy_ms=busy, busy_share=busy / (steady * 1e3), **parts,
        top=[(n[:60], round(ms, 3)) for n, ms in rows[:6]],
        losses=[h["loss"] for h in hist], nll=[h["nll"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist], problems=problems)


def _recurrent_parts(rules, rank, world):
    """The recurrent families' part of a rank of the sharded training
    phase (``sharded_train_rank``; its card, mesh (data 2, model 2) and
    rules): zamba2-7b whole drawn from the seed (the same weights on
    every rank, checked): its decode, then its prefill on the mesh at
    ``RECURRENT_PREFILL_LAYERS``; xlstm-1.3b whole: its decode; then each
    family trained at its cut.
    Returns {part: numbers}."""
    # the first checkpointed backward's lazy imports hold the caller's
    # frames in reference cycles: made before any peak is read
    _warm_lazy_imports()
    out = {}
    for arch in (ZAMBA2, XLSTM):
        t0 = time.perf_counter()
        cfg = _recurrent_decode_cfg(arch)
        params = _decode_weights(arch, M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda"))
        _same_on_ranks(tree_leaves(params), f"{arch} weights")
        print(f"{arch}, rank {rank}: weights drawn and checked in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        out[f"{arch} decode"] = _recurrent_decode(arch, cfg, params, rules,
                                                  rank, world)
        print(f"{arch} sharded decode, rank {rank}: "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        del params
        if arch == ZAMBA2:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            cfg = _recurrent_prefill_cfg()
            box = [M.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(SEED), "cuda")]
            out[f"{arch} prefill"] = _recurrent_prefill(cfg, box, rules,
                                                        rank)
            print(f"{arch} sharded prefill, rank {rank}: "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in RECURRENT_TRAIN:
        t0 = time.perf_counter()
        out[f"{arch} training"] = _recurrent_training(arch, rules, rank)
        print(f"{arch} sharded training, rank {rank}: "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return out


def recurrent_mesh_phase(ranks, counted):
    """The hybrid and ssm families on the mesh (data 2, model 2), as the
    sharded training phase's four ranks ran them (``ranks``: each rank's
    ``_recurrent_parts`` numbers): zamba2-7b (81 layers) and xlstm-1.3b
    (48) decoding with the states split over the batch, zamba2-7b's
    prefill (``RECURRENT_PREFILL_LAYERS``), both trained (``RECURRENT_TRAIN``'s cuts); then the unsharded
    ``loss_fn`` of the same weights and step 0's rows against each
    training's step 0.  Prints each rank's numbers; returns ({path:
    launches}, {part: [each rank's numbers]}, the dry run's counts
    ``counted``)."""
    gc.collect()
    torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= len(ranks) else "gloo"
    card = card_line()
    print(f"recurrent families on a mesh [{card}]: {len(ranks)} ranks on "
          f"(data 2, model 2) over {backend}, the sharded training phase's")
    paths, numbers = {}, {}
    for part in ranks[0]:
        numbers[part] = [dict(r[part], transport=backend) for r in ranks]
    for arch in (ZAMBA2, XLSTM):
        for rank, d in enumerate(numbers[f"{arch} decode"]):
            paths[f"{arch} sharded decode, rank {rank}"] = d["launches"]
            print(f"{arch} sharded decode [{card}], rank {rank}: "
                  f"{d['dtype']} weights, rows "
                  f"{d['rows']} of {d['positions']} (states "
                  f"{d['states_mib_here']:.2f} of {d['states_mib_whole']:.2f}"
                  f" MiB here, its rows' and heads'; the recurrent layers' "
                  f"leaves {d['recurrent_gib_here']:.3f} of "
                  f"{d['recurrent_gib_whole']:.3f} GiB); {d['steps']} steps: K1 "
                  f"{d['launches']['paged_decode_partials']} launches; "
                  f"logits max |sharded - unsharded| {d['max_abs_err']:.4g} "
                  f"(tolerance {SHARD_LOGIT_TOL}), by step "
                  f"{d['step_max_abs_err']}; argmax differs at near ties "
                  f"{d['near_ties']} ({d['decided']} of {d['vectors']} "
                  f"decided); states {d['state_rel_err']:.4g} of each "
                  f"leaf's largest entry (tolerance {d['state_bound']};"
                  f" another data index's rows read {d['wrong_cut_rel']}, "
                  f"another model index's heads {d['wrong_heads_rel']:.4g})"
                  f"; appended kv {d['kv_max_abs_err']:.4g} (tolerance "
                  f"{SHARD_KV_TOL}); step loop {d['sharded_loop_ms']:.2f} ms "
                  f"sharded, {d['unsharded_loop_ms']:.2f} unsharded; "
                  f"profiled step {d['wall_ms']:.2f} ms wall, "
                  f"{d['busy_ms']:.3f} ms device-busy (K1 {d['k1_ms']:.3f})"
                  f"; {d['collectives_per_step']} collectives a step, "
                  f"{d['collectives_ms']:.2f} ms host "
                  f"({100 * d['collectives_share']:.1f}% of the wall); "
                  f"largest rows {d['top']}")
    for rank, d in enumerate(numbers[f"{ZAMBA2} prefill"]):
        paths[f"{ZAMBA2} sharded prefill, rank {rank}"] = d["launches"]
        print(f"{ZAMBA2} sharded prefill [{card}], rank {rank}: "
              f"{d['layers']} layers (cut: the depth "
              f"{get_config(ZAMBA2).num_layers} -> {d['layers']} for the "
              f"run's time), {d['rows']} x {d['seq']} tokens, rows {d['rows_here']} here; K4 "
              f"{d['launches']['prefill_attention']} launches; wall "
              f"{d['wall_ms']:.1f} ms; {d['collectives']} collectives "
              f"({d['collectives_ms']:.1f} ms host); peak "
              f"{d['peak_gib']:.3f} GiB over what the rank held besides "
              f"its arguments; tensor parallelism's collectives "
              f"{d['tp_collectives']} ({d['tp_collectives_ms']:.1f} ms "
              f"host); logits, k, v and states apart "
              f"from the unsharded prefill by {d['rel_errs']} of each "
              f"tensor's largest entry (tolerance {d['bound']};"
              f" another data index's rows read at least "
              f"{d['wrong_cut_rel']})")
    for arch in RECURRENT_TRAIN:
        cfg = _recurrent_train_cfg(arch)
        for rank, d in enumerate(numbers[f"{arch} training"]):
            paths[f"{arch} sharded training, rank {rank}"] = d["launches"]
            per = {k: v // d["steps"] for k, v in d["launches"].items() if v}
            print(f"{arch} sharded training [{card}], rank {rank}: "
                  f"{d['layers']} layers, {d['rows']} x {d['seq_len']} "
                  f"tokens a step ({_recurrent_cut(arch)}); "
                  f"{d['params_here'] / 1e9:.3f} B parameters held (the "
                  f"recurrent layers' leaves {d['recurrent_gib_here']:.3f} "
                  f"of {d['recurrent_gib_whole']:.3f} GiB), state "
                  f"reckoned {d['state_gb']:.2f} GB ({d['held_gib']:.2f} GiB"
                  f" on the card after init, {d['init_s']:.1f} s); step "
                  f"walls {[round(w, 1) for w in d['step_ms']]} ms, "
                  f"{d['tokens_per_s']:.0f} tokens/s (global); peak "
                  f"{d['peak_gib']:.3f} GiB over the "
                  f"{d['held_before_gib']:.3f} the rank held before; "
                  f"collectives a step "
                  f"{d['collectives_per_step']}, host ms "
                  f"{[round(c, 1) for c in d['collectives_ms']]} ("
                  f"{', '.join(f'{100 * c:.1f}%' for c in d['collectives_share'])}"
                  f" of the wall); launches a step {per} (K4 "
                  f"{2 * M.num_kv_layers(cfg)} + {M.num_kv_layers(cfg)} "
                  f"predicted); one step profiled: "
                  f"{d['device_busy_ms']:.1f} ms device-busy "
                  f"({100 * d['busy_share']:.1f}% of the mean wall), K4 "
                  f"forward {d['k4_forward_ms']:.1f}, backward "
                  f"{d['k4_backward_ms']:.1f} ms; losses "
                  f"{[round(x, 5) for x in d['losses']]}, grad_norm "
                  f"{[round(x, 5) for x in d['grad_norms']]}; largest rows "
                  f"{d['top']}")
    problems = [(part, rank, p) for part, ns in numbers.items()
                for rank, n_ in enumerate(ns) for p in n_.pop("problems")]
    assert not problems, problems
    # step 0 against the unsharded loss and gradient norm of the same
    # weights and rows (no design gap: neither family routes experts)
    for arch in RECURRENT_TRAIN:
        ns = numbers[f"{arch} training"]
        assert all(n_["losses"] == ns[0]["losses"] for n_ in ns)
        cfg = _recurrent_train_cfg(arch)
        params = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(SEED), "cuda")
        b = {k: torch.from_numpy(v).cuda() for k, v in next(make_batches(
            SyntheticCorpus(vocab_size=cfg.vocab_size, seed=SEED),
            RECURRENT_TRAIN_ROWS, RECURRENT_TRAIN[arch][1])).items()}
        ref = _loss_and_grad_norm(params, b, cfg)
        by_row = _grad_norm_by_row(params, b, cfg)
        nll_gap = abs(ns[0]["nll"][0] - ref["nll"])
        got = ns[0]["grad_norms"][0]
        gnorm_rel = abs(got - by_row) / by_row
        whole_rel = abs(got - ref["grad_norm"]) / ref["grad_norm"]
        print(f"{arch} sharded training [{card}]: step 0 sharded / "
              f"unsharded (the same weights and rows, the unsharded on the "
              f"card after the ranks end): nll {ns[0]['nll'][0]:.6f} / "
              f"{ref['nll']:.6f} ({nll_gap:.3g} apart, tolerance "
              f"{SHARDED_LOSS_TOL}); grad_norm {got:.6f} / {by_row:.6f} with "
              f"the rows taken one a pass, as a data index takes them "
              f"({gnorm_rel:.3g} apart, tolerance {SHARDED_GNORM_REL}), / "
              f"{ref['grad_norm']:.6f} with both rows in one pass "
              f"({whole_rel:.3g} apart: the bf16 gradient's sensitivity to "
              f"how the rows are grouped in a product)")
        assert nll_gap <= SHARDED_LOSS_TOL, (arch, ns[0]["nll"], ref)
        assert gnorm_rel <= SHARDED_GNORM_REL, (arch, got, by_row)
        for n_ in ns:
            n_["unsharded_step0"] = dict(ref, grad_norm_by_row=by_row)
        del params, b
        gc.collect()
        torch.cuda.empty_cache()
    return paths, numbers, counted


def _grad_norm_by_row(params, batch, cfg):
    """The global norm of ``loss_fn``'s gradient at ``params`` over
    ``batch``, its rows taken one a pass (each row's NLL over the batch's
    count of labels, the passes' bf16 gradients summed in f32), as the
    ranks of a mesh whose ``data`` axis gives each index one row take
    them: xLSTM's bf16 gradient moves by percents with how the rows are
    grouped in a product (its norm 2.4% apart, one pass against two, as
    measured on a CPU at 16 layers and full width; 2.4e-6 in f32)."""
    leaves = tree_leaves(params)
    count = float((batch["labels"] >= 0).sum())
    total = None
    for r in range(batch["tokens"].shape[0]):
        row = {k: v[r:r + 1] for k, v in batch.items()}
        scale = float((row["labels"] >= 0).sum()) / count
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, _ = M.loss_fn(params, row, cfg)
            grads = torch.autograd.grad(loss * scale, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [g.float() for g in grads]
        total = grads if total is None else [a + g for a, g in
                                             zip(total, grads)]
        del grads
    return float(torch.sqrt(sum(torch.sum(g * g) for g in total)))


def _count_recurrent():
    """The dry run of the recurrent families' steps that
    ``recurrent_mesh_phase`` runs: rank 0's program in a fake world of
    four ranks on ``RECURRENT_MESH`` on ``meta`` tensors, counted
    (``launch.op_analysis``).  Returns {part: its count}."""
    n_ranks = RECURRENT_MESH[0][0] * RECURRENT_MESH[0][1]
    fake_world(n_ranks)
    try:
        rules = make_rules(Mesh(*RECURRENT_MESH))
        steps = {}
        for arch in RECURRENT_TRAIN:
            cfg = _recurrent_train_cfg(arch)
            steps[f"{arch} training"] = (cfg, build_step(cfg, InputShape(
                "recurrent", RECURRENT_TRAIN[arch][1], RECURRENT_TRAIN_ROWS,
                "train"), rules))
        cfg = _recurrent_prefill_cfg()
        steps[f"{ZAMBA2} prefill"] = (cfg, build_step(cfg, InputShape(
            "recurrent", RECURRENT_PREFILL_SEQ, RECURRENT_PREFILL_ROWS,
            "prefill"), rules))
        for arch in (ZAMBA2, XLSTM):
            cfg = _recurrent_decode_cfg(arch)
            b, L = len(RECURRENT_POS), M.num_kv_layers(cfg)
            meta_i32 = lambda n: torch.empty(  # noqa: E731
                (n,), dtype=torch.int32, device="meta")
            st = M.DecodeState(
                tokens=meta_i32(b), pos=meta_i32(b),
                kv=_meta_pools(L, RECURRENT_SLOTS, RECURRENT_BS,
                               cfg.num_kv_heads, cfg.resolved_head_dim, b)
                if L else None, peer=None,
                states=M.init_states(cfg, b, "meta"))
            p_r, st_r = shard_decode(
                _decode_weights(arch, M.abstract_params(cfg)), st, cfg, rules)
            steps[f"{arch} decode"] = (cfg, (
                lambda p, s, cfg=cfg: M.serve_step(p, s, cfg, rules=rules),
                (p_r, st_r)))
        counted = {}
        for part, (cfg, (fn, args)) in steps.items():
            _, counted[part] = op_count(fn, args, gloo=True)
    finally:
        torch.distributed.destroy_process_group()
    return counted


def _dry_recurrent(card, recurrent, counted):
    """``_count_recurrent``'s counts (``counted``) held to what every rank
    measured (``recurrent``, ``recurrent_mesh_phase``'s numbers): each
    training step's and the prefill's launches and collective calls
    exactly and their peaks within ``DRYRUN_PEAK_REL``; each decode step's
    K1 launches and collective calls exactly.  Returns the numbers
    kept."""
    out = {}
    n_ranks = RECURRENT_MESH[0][0] * RECURRENT_MESH[0][1]
    for part, c in counted.items():
        ns = recurrent[part]
        calls, launches = c.collective_calls, c.launches()
        pred_peak = c.mem["total_bytes"]
        if part.endswith("decode"):
            measured = [(n_["collectives_per_step"],
                         {k: v // n_["steps"] for k, v in
                          n_["launches"].items() if v}) for n_ in ns]
            peaks = None
        elif part.endswith("prefill"):
            measured = [(n_["collectives"], {k: v for k, v in
                                             n_["launches"].items() if v})
                        for n_ in ns]
            peaks = [n_["peak_gib"] * 2 ** 30 for n_ in ns]
        else:
            measured = [(n_["collectives_per_step"], {
                k: v // n_["steps"] for k, v in n_["launches"].items() if v})
                for n_ in ns]
            peaks = [n_["peak_gib"] * 2 ** 30 for n_ in ns]
        print(f"dry run [{card}]: {part} on the mesh, rank 0 of {n_ranks} "
              f"(mesh {RECURRENT_MESH[0]}): collectives predicted {calls} "
              f"({c.collectives}, bytes on the ring model), launches "
              f"predicted {launches}; measured (collectives, launches) "
              f"{measured} (each rank's; a step's, the training's each "
              f"step's); peak predicted {pred_peak / 2 ** 30:.3f} GiB a rank"
              + ("" if peaks is None else
                 f", measured {[round(x / 2 ** 30, 3) for x in peaks]} GiB "
                 f"(tolerance {100 * DRYRUN_PEAK_REL:.0f}%)")
              + f"; {_terms(c)}")
        for rank, (coll, lau) in enumerate(measured):
            want = coll if isinstance(coll, list) else [coll]
            assert all(k == calls for k in want), (part, rank, calls, coll)
            assert lau == launches, (part, rank, lau, launches)
        for rank, peak in enumerate(peaks or []):
            assert abs(pred_peak - peak) <= DRYRUN_PEAK_REL * peak, \
                (part, rank, pred_peak, peak)
        out[part] = dict(collective_calls=calls, collectives=c.collectives,
                         launches_per_step=launches, peak_bytes=pred_peak,
                         **dry_roofline(c))
    return out


# ---------------------------------------------------------------------------
# the dry run held to the card
# ---------------------------------------------------------------------------

#: largest |predicted - measured| / measured peak memory of a training
#: run: the dry run's peak of live storages (``launch.op_analysis`` over
#: ``meta`` tensors, nothing allocated) against the card's
#: ``torch.cuda.max_memory_allocated()`` over the run (the weights' draw
#: and every step); the card's allocator adds its 512-byte rounding and
#: the kernels' own workspaces, which the meta branches do not allocate.
#: Measured on an H100 80GB HBM3: -0.16% (danube), -0.17% (phi-tiny-moe),
#: -0.56% (a sharded rank), each well inside this.  The ranks that share
#: the one card talk over gloo, whose reduce-scatter holds a copy of its
#: operand on the card while it runs, so their steps are counted with
#: that copy (``count(..., gloo=True)``): xlstm-1.3b's rank at 16 layers
#: read 5.2% over the count without it, its peak inside the reduce-scatter
#: of a 412 MB f32 gradient of the vocabulary's width
DRYRUN_PEAK_REL = 0.02


def _terms(c) -> str:
    r = dry_roofline(c)
    return (f"predicted terms compute {r['compute_term_s'] * 1e3:.2f} ms, "
            f"memory {r['memory_term_s'] * 1e3:.2f} ms, collective "
            f"{r['collective_term_s'] * 1e3:.2f} ms ({r['bottleneck']}; "
            f"{r['hardware']} model)")


def _meta_pools(L, n, bs, nkv, hd, b):
    """f32 pools of ``n`` slots on ``meta``, as the card's paths hold
    them."""
    pool = (L, n, bs, nkv, hd)
    i32 = torch.int32
    return M.KVPools(*(torch.empty(pool, device="meta") for _ in range(2)),
                     *(torch.empty((k,), dtype=i32, device="meta")
                       for k in (n, n, b, b)))


def dry_run_phase(trained, yi_step, sharded, recurrent, counted):
    """The dry run of what the card just ran (``launch.specs.build_step``
    or the same step's ``meta`` arguments, counted by
    ``launch.op_analysis``; no kernel launched, nothing allocated) held to
    it: each kernel's launches a step equal to the counters' over the
    training runs of ``trained`` ({arch: (launches over the run, its
    numbers)}, ``train_path``'s) and the predicted peak within
    ``DRYRUN_PEAK_REL`` of ``max_memory_allocated``, a sharded rank's
    too; K1's launches a step
    equal to yi-6b's full-width step in fetch mode and in place
    (``yi_step``, ``inplace_step``'s numbers); and the collective calls a
    step of the sharded training phase's rank 0 program (a fake world of
    four ranks) equal to each rank's each step (``sharded``).  The three
    roofline terms are printed beside each measured step's wall and
    device-busy ms; then the recurrent families' steps on the mesh
    (``recurrent``, held to their counts ``counted`` by
    ``_dry_recurrent``).  Returns the numbers kept."""
    card = card_line()
    out = {}
    for arch, (launches, nums) in trained.items():
        cfg = get_config(arch)
        steps = nums["steps"]
        fn, args = build_step(cfg, InputShape(
            "train_path", nums["tokens_per_step"], 1, "train"), None)
        _, c = op_count(fn, args)
        measured = {k: v // steps for k, v in launches.items() if v}
        assert all(v % steps == 0 for v in launches.values()), launches
        predicted = c.launches()
        peak = nums["peak_gib"] * 2 ** 30
        pred = c.mem["total_bytes"]
        rel = (pred - peak) / peak
        print(f"dry run [{card}]: {arch} training step (1 x "
              f"{nums['tokens_per_step']} tokens, one card): launches a step "
              f"predicted {predicted}, measured {measured}; peak predicted "
              f"{pred / 2 ** 30:.3f} GiB (arguments "
              f"{c.mem['argument_bytes'] / 2 ** 30:.3f}, temporaries "
              f"{c.mem['temp_bytes'] / 2 ** 30:.3f}), measured "
              f"{peak / 2 ** 30:.3f} GiB, {100 * rel:+.2f}% (tolerance "
              f"{100 * DRYRUN_PEAK_REL:.0f}%); {_terms(c)}; measured step "
              f"wall {nums['steady_step_ms']:.1f} ms, device-busy "
              f"{nums['device_busy_ms']:.1f} ms")
        assert predicted == measured, (arch, predicted, measured)
        assert abs(rel) <= DRYRUN_PEAK_REL, (arch, pred, peak)
        out[f"{arch} training"] = dict(
            launches_per_step=predicted, peak_bytes=pred,
            measured_peak_bytes=peak, peak_rel=rel, **dry_roofline(c),
            step_ms=nums["steady_step_ms"],
            device_busy_ms=nums["device_busy_ms"])

    cfg = get_config("yi-6b")
    pos, bs = yi_step["positions"], yi_step["bs"]
    L, b, n = M.num_kv_layers(cfg), len(pos), sum(p // bs + 1 for p in pos)
    pools = lambda: _meta_pools(L, n, bs, cfg.num_kv_heads,  # noqa: E731
                                cfg.resolved_head_dim, b)
    fetch = M.DecodeState(
        tokens=torch.empty((b,), dtype=torch.int32, device="meta"),
        pos=torch.empty((b,), dtype=torch.int32, device="meta"),
        kv=pools(), peer=None)
    params = M.abstract_params(cfg)
    for mode, st, key in (("fetch", fetch, "k1_fetch"),
                          ("inplace", fetch._replace(peer=pools()),
                           "k1_inplace")):
        _, c = op_count(lambda p, s: M.serve_step(
            p, s, cfg, harvest_inplace=s.peer is not None), (params, st))
        k1 = c.launches().get("paged_decode_partials", 0)
        print(f"dry run [{card}]: yi-6b decode step {mode} (rows at {pos}, "
              f"f32 pools of {n} slots of {bs}): K1 launches predicted {k1}, "
              f"measured {yi_step[key]}; {_terms(c)}; measured step wall "
              f"{yi_step[mode]['wall_ms']:.2f} ms, device-busy "
              f"{yi_step[mode]['busy_ms']:.3f} ms")
        assert k1 == yi_step[key], (mode, k1, yi_step[key])
        out[f"yi-6b decode {mode}"] = dict(
            k1_launches=k1, **dry_roofline(c),
            step_ms=yi_step[mode]["wall_ms"],
            device_busy_ms=yi_step[mode]["busy_ms"])

    n_ranks = TRAIN_MESH[0][0] * TRAIN_MESH[0][1]
    fake_world(n_ranks)
    try:
        cfg = _sharded_cfg()
        fn, args = build_step(cfg, InputShape(
            "sharded", SHARDED_SEQ, SHARDED_ROWS, "train"),
            make_rules(Mesh(*TRAIN_MESH)))
        _, c = op_count(fn, args, gloo=True)
    finally:
        torch.distributed.destroy_process_group()
    calls = c.collective_calls
    print(f"dry run [{card}]: {PHI_TINY} sharded training step, rank 0 of "
          f"{n_ranks} (mesh {TRAIN_MESH[0]}, {cfg.num_layers} layers, "
          f"{SHARDED_ROWS} x {SHARDED_SEQ} tokens): collectives predicted "
          f"{calls} a step ({c.collectives}, bytes on the ring model), "
          f"measured {[n_['collectives_per_step'] for n_ in sharded]} (each "
          f"rank's steps); launches a step predicted {c.launches()}; peak "
          f"predicted {c.mem['total_bytes'] / 2 ** 30:.3f} GiB a rank, "
          f"measured {[round(n_['peak_gib'], 3) for n_ in sharded]} GiB "
          f"(each rank's, over its timed steps; tolerance "
          f"{100 * DRYRUN_PEAK_REL:.0f}%); {_terms(c)}; measured step wall "
          f"{[round(n_['steady_step_ms'], 1) for n_ in sharded]} ms, "
          f"device-busy {[round(n_['device_busy_ms'], 1) for n_ in sharded]}"
          f" ms")
    for rank, n_ in enumerate(sharded):
        assert all(k == calls for k in n_["collectives_per_step"]), \
            (rank, calls, n_["collectives_per_step"])
        peak = n_["peak_gib"] * 2 ** 30
        assert abs(c.mem["total_bytes"] - peak) <= DRYRUN_PEAK_REL * peak, \
            (rank, c.mem["total_bytes"], peak)
        per = {k: v // n_["steps"] for k, v in n_["launches"].items() if v}
        assert per == c.launches(), (rank, per, c.launches())
    out[f"{PHI_TINY} sharded training"] = dict(
        collective_calls=calls, collectives=c.collectives,
        launches_per_step=c.launches(), peak_bytes=c.mem["total_bytes"],
        **dry_roofline(c))
    out.update(_dry_recurrent(card, recurrent, counted))
    return out


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
    t_phase = time.perf_counter()
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
    musicgen = get_config(MUSICGEN)
    npre = qwen2_vl.modality.num_prefix_embeddings
    # musicgen-medium's rows: its 64 conditioning positions and each prompt
    audio_pos = tuple(musicgen.modality.num_prefix_embeddings + n
                      for n in MUSICGEN_FRAMES)
    bs = 8
    # K1's 10-slot decode shape at Llama-4's 48 and qwen2-vl-72b's 80
    # layers, so that its pools cycle past the L2 as the other models' do
    kernels = [check_paged_decode(yi, bs, more=[nemotron, command_r,
                                                get_config(LLAMA4),
                                                get_config(QWEN2_VL), zamba2,
                                  musicgen],
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
            ("zamba2-7b smoke prompt (MHA, hd 112)", zamba2, 40, {}),
            (f"{MUSICGEN} 64 conditioning positions and a "
             f"{MUSICGEN_FRAMES[-1]}-frame prompt (MHA, hd 64)", musicgen,
             audio_pos[-1], {})])] \
        + check_movers([(yi, bs), (danube, 16), (llama4, 16),
                        (command_r, bs), (nemotron, bs), (qwen2_vl, bs),
                        (dbrx, bs), (zamba2, bs), (moe, bs)]) \
        + [check_moe_ffn(moe, get_config("phi-tiny-moe"))]
    # K1 as the in-place mode calls it, at musicgen-medium's decode shape
    # and rows, over a local and a peer pool
    two_pools = time_two_pool_k1(musicgen, 16, audio_pos)
    kernels[0]["by_shape"].append(two_pools)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    two_pools["max_abs_err"])
    phi = get_config("phi-tiny-moe")
    k4_bwd, k4_train_fwd = check_flash_bwd(danube, yi, llama4, zamba2, phi)
    kernels.append(k4_bwd)
    next(k for k in kernels if k["name"] == "prefill_attention")[
        "training_forward_with_lse"] = k4_train_fwd
    kernels += check_moe_ffn_bwd(phi, moe, get_config(DBRX))
    check_row_parallel()
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
                 "sums taken in another order)",
                 "moe_ffn_bwd": "bf16 2^-7, f32 1e-5 of each gradient's "
                 "largest entry (dA, dH, dG rounded from sums in another "
                 "order than cuBLAS's); bf16 repeats bit for bit",
                 "moe_ffn_train": "bf16 rtol 1.6e-2, atol 2^-7, the output "
                 "and A, h, g alike (sums in another order than cuBLAS); "
                 "repeats bit for bit"}
    t_phase = phase_done("kernels against their plain versions", t_phase)
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
            (XLSTM, (5, 40), 10, dict(num_layers=4)),
            (MIXTRAL, (5, 40), 10, {}),
            (PHI35, (5, 40), 10, {})):
        tokens = check_reduced_tokens(arch, prompt, slots, **changes)
        label = {k: v for k, v in changes.items() if k != "moe"}
        if "moe" in changes:
            label["layer_period"] = changes["moe"].layer_period
        print(f"reduced {arch} {label or ''}: cpu and cuda tokens "
              f"identical ({tokens[:2]} ...)")
    # the audio family at model level (the engine refuses it): prefill,
    # then decode in fetch mode and in place, card against CPU
    fetch_toks, inplace_toks = check_reduced_audio()
    print(f"reduced {MUSICGEN}: cpu and cuda (steps, rows, codebooks) "
          f"tokens identical, fetch {tuple(fetch_toks.shape)} and in place "
          f"({fetch_toks[:2, 0].tolist()} / {inplace_toks[:2, 0].tolist()} "
          f"...)")
    t_phase = phase_done("reduced models served and decoded, CPU and card",
                         t_phase)
    # MoE training, card against CPU: phi-tiny-moe at an odd expert width
    # (its tiles ragged, its weights staged by plain loads), qwen2-moe (a
    # shared expert), Llama-4 at 4 layers with its dense/MoE interleaving
    for arch, changes in (
            ("h2o-danube-3-4b", {}),
            ("phi-tiny-moe", dict(moe=dataclasses.replace(
                get_config("phi-tiny-moe").reduced().moe, d_ff_expert=183))),
            ("qwen2-moe", {}),
            (LLAMA4, dict(num_layers=4, moe=dataclasses.replace(
                l4_moe, layer_period=2)))):
        for dtype in (torch.float32, torch.bfloat16):
            check_reduced_training(arch, dtype, **changes)

    t_phase = phase_done("reduced models trained, CPU and card", t_phase)
    # ---- phases 5 to 10: the paths at full width ----
    movers = ["paged_decode_partials", "quantize_demote",
              "dequantize_reload", "prefill_attention", "gather_blocks",
              "copy_blocks"]
    paths = {}
    # each served model's weights then take one decode step in fetch mode
    # and one in place (its launches a path of their own): yi-6b with each
    # row's first block on the peer
    paths["yi-6b"], _, (paths["yi-6b in-place step"], inplace_yi) = \
        main_path("yi-6b", bs, movers, on_model=inplace_step(
            "yi-6b", bs, (41, 24, 33, 17), lambda r, j: j == 0))
    paths["qwen2-moe"], _, _ = main_path("qwen2-moe", bs,
                                         movers + ["moe_ffn"])
    # the long-prompt path: 4 requests of 4,500-6,000 tokens (past the
    # 4,096-token window), 2 rows, 16-token blocks; 800 local slots hold
    # two requests' blocks, and each preemption evicts a request's 280-375
    # blocks past a peer budget of 64 into the host; its in-place step
    # puts the first half of each row's blocks on the peer, inside and
    # outside the 4,096-token window
    danube_pos = (5999, 4700)
    paths["h2o-danube-3-4b"], k1_long, \
        (paths["h2o-danube-3-4b in-place step"], inplace_danube) = main_path(
            "h2o-danube-3-4b", 16, movers, num_requests=4, local_slots=800,
            peer_blocks=64, max_batch=2, prompt=(4500, 6000),
            profile_pos=danube_pos, profile_slots=800, prefill_tokens=6000,
            profile_evict=True, on_model=inplace_step(
                "h2o-danube-3-4b", 16, danube_pos,
                lambda r, j: j < (danube_pos[r] // 16 + 1) // 2))
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
    # mixtral-8x7b (8 experts top-2 of width 14,336, sliding window 4,096)
    # and phi-3.5-moe (16 top-2 of 6,400) at 16 of their 32 layers, and
    # phi-tiny-moe whole, on yi-6b's workload; K7 then at each decode
    # shape (4 rows, top-2) on the model's own experts
    k7_more = {}
    for arch, layers in ((MIXTRAL, MIXTRAL_LAYERS), (PHI35, PHI35_LAYERS),
                         (PHI_TINY, None)):
        paths[arch], _, k7_more[arch] = main_path(
            arch, bs, movers + ["moe_ffn"], layers=layers,
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
    # two ranks decode yi-6b (fetch and in place), h2o-danube-3-4b and
    # phi-tiny-moe with the pool's slots (and the experts) sharded over
    # them; each rank's launches a path of their own
    t_phase = phase_done("the served paths", t_phase)
    sharded_paths, sharded = sharded_phase()
    paths.update(sharded_paths)
    t_phase = phase_done("sharded decode", t_phase)
    # musicgen-medium whole (48 layers) at model level: prefill through K4,
    # decode through K1 in fetch mode and in place
    paths[MUSICGEN], audio = audio_path()
    t_phase = phase_done(MUSICGEN, t_phase)
    # the training path: full-width h2o-danube-3-4b, 1 x 8,192 tokens
    # (twice its window) a step, through K4's forward and backward
    paths["h2o-danube-3-4b training"], training = train_path()
    # phi-tiny-moe at full width and depth (3.812 B parameters, 16 experts
    # top-2 of width 915), 1 x 8,192 tokens a step, through K4's and K7's
    # forward and backward
    paths["phi-tiny-moe training"], training_moe = train_path("phi-tiny-moe")
    check_no_backward()
    t_phase = phase_done("the training paths", t_phase)
    # four ranks train phi-tiny-moe at full width on the mesh (data 2,
    # model 2): FSDP over data, experts over model; each rank's launches a
    # path of their own
    # then, in the same ranks, the hybrid and ssm families: zamba2-7b and
    # xlstm-1.3b whole decode with their states split over the batch,
    # zamba2-7b's prefill on the mesh, both trained at their cuts; each
    # rank's launches a path of their own
    sharded_train_paths, sharded_training, recurrent_ranks, dry_counts = \
        sharded_training_phase()
    paths.update(sharded_train_paths)
    t_phase = phase_done("sharded training and the recurrent families' "
                         "ranks", t_phase)
    recurrent_paths, recurrent, recurrent_counted = recurrent_mesh_phase(
        recurrent_ranks, dry_counts)
    paths.update(recurrent_paths)
    t_phase = phase_done("the recurrent families on a mesh", t_phase)
    # the dry run of the steps just measured, held to them
    dry = dry_run_phase(
        {"h2o-danube-3-4b": (paths["h2o-danube-3-4b training"], training),
         PHI_TINY: (paths["phi-tiny-moe training"], training_moe)},
        inplace_yi, sharded_training, recurrent, recurrent_counted)
    phase_done("the dry run held to the card", t_phase)
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] == "paged_decode_partials":
            k["long_pool"] = k1_long
            k["llama4_pool"] = k1_llama4
            k["inplace_steps"] = {"yi-6b": inplace_yi,
                                  "h2o-danube-3-4b": inplace_danube,
                                  MUSICGEN: audio}
            k["sharded"] = sharded
            k["recurrent_mesh"] = recurrent[f"{ZAMBA2} decode"]
        if k["name"] == "prefill_attention":
            k["recurrent_mesh"] = {
                "prefill": recurrent[f"{ZAMBA2} prefill"],
                "training": recurrent[f"{ZAMBA2} training"]}
        if k["name"] == "prefill_attention_bwd":
            k["training"] = training
        if k["name"] == "moe_ffn_bwd":
            k["training"] = training_moe
            k["sharded_training"] = sharded_training
        if k["name"] == "moe_ffn":
            k["by_shape"] += [k7_llama4, k7_dbrx, *k7_more.values()]
            k["max_abs_err"] = max(
                [k["max_abs_err"], k7_llama4["max_abs_err"],
                 k7_dbrx["max_abs_err"]]
                + [r["max_abs_err"] for r in k7_more.values()])
            k["sharded"] = {PHI_TINY: sharded[PHI_TINY]}
    print(f"dry run: {json.dumps(dry)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
