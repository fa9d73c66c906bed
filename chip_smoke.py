"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel in ``src/repro_torch/csrc`` with nvcc (in parallel);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the full-width yi-6b serving path gives it and at edge cases,
     and time kernel, plain version and bound;
  4. reduced yi-6b served on the CPU (plain versions) and on the card
     (kernels): identical tokens;
  5. the main path: full-width yi-6b (random weights from a seed) served
     through ``HarvestRuntime(...).server(...)`` with evictions, reloads and
     quantized demotions; every kernel must have launched; then one
     full-width decode step profiled (wall time, device-busy share, the
     largest kernels);
then the card's name and power limit, one JSON line of per-kernel
numbers, and the JSON result line.  It imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import dataclasses
import json
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.harvest_copy import ops as hops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import TenantSpec, Workload  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
MiB = 2 ** 20
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def time_ms(fn, iters=50):
    """(device ms, events ms) per call of ``fn``.  Device ms is the sum of
    the durations of every kernel, memset and copy the call puts on the
    card, from the profiler's trace; where the trace shows no device time
    it falls back to the events time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    wall = events_ms(fn, iters)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # one profiling cycle is all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    us = 0.0
    for row in prof.key_averages():
        us += getattr(row, "self_device_time_total",
                      getattr(row, "self_cuda_time_total", 0.0))
    return (us / 1e3 / iters if us > 0 else wall), wall


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
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


def check_paged_decode(full_cfg, bs):
    """K1 at the full-width decode shapes (gq 8, hd 128) and edge cases:
    free slots, an empty request, sliding window, chunked-local."""
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

    # timing at the main path's shapes (4 batch rows, a 10-slot pool of
    # 8-token blocks per layer, all 10 slots owned), cycling through 128
    # layer pools as a decode step cycles through its 32: 80 MiB, more than
    # the 50 MB L2, so each call finds its pool cold as in the step (where
    # the weights stream between two layers' calls)
    L = 4 * full_cfg.num_layers
    q_pos = (23, 15, 31, 7)
    s = paged_scenario(rng, 4, 10, bs, nkv, nq, hd, q_pos, layers=L)
    layer = [0]

    def kernel():
        i = layer[0] = (layer[0] + 1) % L
        pops.paged_decode_partials(s["q"], s["pk"][i], s["pv"][i],
                                   s["slot_req"], s["slot_base"], s["q_pos"],
                                   scale=hd ** -0.5)

    def plain():
        i = layer[0] = (layer[0] + 1) % L
        pops.paged_decode_partials_plain(s["q"], s["pk"][i], s["pv"][i],
                                         s["slot_req"], s["slot_base"],
                                         s["q_pos"], scale=hd ** -0.5)

    got = pops.paged_decode_partials(s["q"], s["pk"][0], s["pv"][0],
                                     s["slot_req"], s["slot_base"],
                                     s["q_pos"], scale=hd ** -0.5)
    ref = pops.paged_decode_partials_plain(s["q"], s["pk"][0], s["pv"][0],
                                           s["slot_req"], s["slot_base"],
                                           s["q_pos"], scale=hd ** -0.5)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        err = max(err, (a - b).abs().max().item())
    (ms, ms_wall), (plain_ms, _) = time_ms(kernel, 320), time_ms(plain, 64)
    print(f"  paged_decode_partials: {ms_wall:.4f} ms per call between "
          f"events (host-bound at this size)")
    # the work this data needs: each valid position's k and v row of each
    # kv head read once, q read, (m, l, acc) written; 4 flops per q row per
    # position per hd column (score and weighted sum)
    positions = sum(p + 1 for p in q_pos)
    b, gq, n_slots = len(q_pos), nq // nkv, s["slot_req"].shape[0]
    nbytes = 4 * (2 * positions * nkv * hd          # k and v rows
                  + b * nq * hd                     # q
                  + 2 * n_slots + b                 # slot_req/base, q_pos
                  + b * nq * (2 + hd))              # m, l, acc
    flops = 4 * positions * nkv * gq * hd
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(name="paged_decode_partials", route="cuda",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:75",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_quant(full_cfg, bs):
    """K2 and K3 against their plain versions: every fidelity, an odd
    width, an all-zero row, the full-width demoted block (one row of
    L_kv * 2 * bs * nkv * hd f32, as the engine's _degrade passes it),
    out-of-range ids raising; values, scales and pools bit for bit."""
    rng = np.random.default_rng(SEED + 1)
    elems = (M.num_kv_layers(full_cfg) * 2 * bs * full_cfg.num_kv_heads
             * full_cfg.resolved_head_dim)
    err = {"quantize_demote": 0.0, "dequantize_reload": 0.0}
    for fid in ("int8", "fp8", "int4"):
        for width in (37, elems):
            src = (rng.normal(size=(6, width))
                   * rng.uniform(0.01, 30, size=(6, 1))).astype(np.float32)
            src[3] = 0.0
            ids = np.asarray([3, 5, 0], np.int32)
            src_t = torch.from_numpy(src)
            pv, ps = hops.quantize_blocks_plain(src_t.cuda(), ids, fid)
            gv, gs = hops.quantize_blocks(src_t.cuda(), ids, fidelity=fid)
            assert torch.equal(gv.view(torch.uint8), pv.view(torch.uint8)), \
                (fid, width)
            assert torch.equal(gs, ps), (fid, width)
            err["quantize_demote"] = max(
                err["quantize_demote"],
                (gv.float() - pv.float()).abs().max().item(),
                (gs - ps).abs().max().item())
            dst = torch.from_numpy(rng.normal(size=(7, width)).astype(
                np.float32)).cuda()
            dids = np.asarray([6, 1, 2], np.int32)
            ref = hops.dequantize_blocks_plain(dst.clone(), pv, ps, dids, fid)
            got = hops.dequantize_blocks(dst.clone(), gv, gs, dids,
                                         fidelity=fid)
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
            err["dequantize_reload"] = max(err["dequantize_reload"],
                                           (got - ref).abs().max().item())
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
    # slo policy's quantized classes), a (1, elems) row on the device;
    # rows cycle through a 64 MiB pool so the source is not L2-resident
    pool = torch.from_numpy(rng.normal(size=(64, elems)).astype(
        np.float32)).cuda()
    row_ids = [torch.tensor([i], dtype=torch.int32, device="cuda")
               for i in range(64)]
    nxt = [0]

    def ids():
        nxt[0] = (nxt[0] + 1) % 64
        return row_ids[nxt[0]]

    vals, scales = hops.quantize_blocks(pool, row_ids[0], fidelity="int8")
    dst = torch.zeros_like(pool)
    out = []
    for fn_k, fn_p, nbytes, name, src_file, line in (
        (lambda: hops.quantize_blocks(pool, ids(), fidelity="int8"),
         lambda: hops.quantize_blocks_plain(pool, ids(), "int8"),
         4 * elems + elems + 4, "quantize_demote", "harvest_quant.cu", 199),
        (lambda: hops.dequantize_blocks(dst, vals, scales, ids(),
                                        fidelity="int8"),
         lambda: hops.dequantize_blocks_plain(dst, vals, scales, ids(),
                                              "int8"),
         elems + 4 + 4 * elems, "dequantize_reload", "harvest_quant.cu",
         246),
    ):
        (ms, ms_wall), (plain_ms, _) = time_ms(fn_k, 200), time_ms(fn_p, 50)
        print(f"  {name}: {ms_wall:.4f} ms per call between events")
        bound_ms, bound_by = bound(nbytes, 3 * elems)
        out.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src_file}",
            replaces=f"src/repro/kernels/harvest_copy/kernel.py:{line}",
            max_abs_err=err[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None))
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving path
# ---------------------------------------------------------------------------


def serve(cfg, params, device, *, num_requests, local_slots, peer_budget,
          max_batch, bs=8, max_new_tokens=16, prompt=(5, 40)):
    """Serve a seeded Poisson workload (a latency tenant kept at full
    precision and a batch tenant demoted at int8) through the front door;
    returns (server, stats, per-step decode wall times)."""
    runtime = HarvestRuntime({1: peer_budget})
    server = runtime.server(cfg, params, max_batch=max_batch, block_size=bs,
                            num_local_slots=local_slots, scheduler="fair",
                            mode="async", fidelity_policy="slo",
                            device=device)
    eng = server.engine
    step_s = []
    compute = eng._compute

    def timed_compute():
        t0 = time.perf_counter()
        logits = compute()
        if logits.is_cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        assert torch.isfinite(logits).all(), "non-finite logits"
        return logits

    eng._compute = timed_compute
    stats = server.run(Workload(
        num_requests=num_requests, arrival="poisson", rate=2e4, seed=SEED,
        vocab=(3, min(cfg.vocab_size, 250)),
        tenants=(TenantSpec("latency", slo="latency", prompt_len=prompt,
                            max_new_tokens=max_new_tokens),
                 TenantSpec("batch", slo="batch", prompt_len=prompt,
                            max_new_tokens=max_new_tokens))))
    return server, stats, step_s


def check_reduced_tokens():
    """Reduced yi-6b on the CPU (plain versions) and on the card (kernels).
    The weights are f32 here: with bf16 logits a near tie can flip on a
    rounding step between two GEMM libraries; in f32 the rounding noise is
    far below any gap, so identical tokens show the kernels right."""
    cfg = get_config("yi-6b").reduced()
    params = _map(M.init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu"), lambda t: t.float())
    runs = {}
    for device in ("cpu", "cuda"):
        p = _map(params, lambda t: t.to(device))
        # the main path's geometry with the peer budget scaled to the
        # reduced block size: evictions to peer and host, int8 demotions
        server, stats, _ = serve(cfg, p, device, num_requests=6,
                                 local_slots=10, peer_budget=24 * 1024,
                                 max_batch=4)
        stats.check_clock_identity()
        runs[device] = ([h.tokens for h in server.handles],
                        dict(server.engine.kv_mgr.stats), stats.clock_s)
    assert runs["cpu"] == runs["cuda"], runs
    kv = runs["cuda"][1]
    assert kv["evict_to_peer"] + kv["evict_to_host"] > 0, kv
    return runs["cuda"][0]


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def profile_decode_step(cfg, params, bs, steps=5):
    """Where one full-width decode step's time goes: 4 rows at positions
    of 18-42 tokens over a 20-slot pool, the step run ``steps`` times
    under the profiler.  Returns (wall ms per step, device-busy ms per
    step, [(kernel name, device ms per step)] of the five largest)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    L, nkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    n_slots, pos = 20, [41, 24, 33, 17]
    pool = torch.from_numpy(rng.normal(
        size=(2, L, n_slots, bs, nkv, hd)).astype(np.float32)).cuda()
    slot_req = np.full((n_slots,), -1, np.int32)
    slot_base = np.zeros((n_slots,), np.int32)
    append_slot = np.zeros((4,), np.int32)
    slot = 0
    for r, p in enumerate(pos):
        for j in range(p // bs + 1):
            slot_req[slot], slot_base[slot] = r, j * bs
            if j == p // bs:
                append_slot[r] = slot
            slot += 1
    dev = {k: torch.from_numpy(v).cuda() for k, v in dict(
        slot_req=slot_req, slot_base=slot_base, append_slot=append_slot,
        append_off=np.asarray(pos, np.int32) % bs,
        pos=np.asarray(pos, np.int32),
        tokens=rng.integers(3, 250, size=4).astype(np.int32)).items()}
    state = M.DecodeState(
        tokens=dev["tokens"], pos=dev["pos"], peer=None, kv=M.KVPools(
            pool[0], pool[1], dev["slot_req"], dev["slot_base"],
            dev["append_slot"], dev["append_off"]))

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
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    rows = [(row.key, getattr(row, "self_device_time_total",
                              getattr(row, "self_cuda_time_total", 0.0))
             / 1e3 / steps) for row in prof.key_averages()]
    rows.sort(key=lambda kv: -kv[1])
    return wall_ms, sum(ms for _, ms in rows), rows[:5]


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
        for line in build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    full = get_config("yi-6b")
    bs = 8
    kernels = [check_paged_decode(full, bs)] + check_quant(full, bs)
    tolerance = {"paged_decode_partials": "rtol 1e-4, atol 1e-4 (f32 sums "
                 "in another order)", "quantize_demote": "bit-identical",
                 "dequantize_reload": "bit-identical"}
    for k in kernels:
        print(f"kernel {k['name']}: ms {k['ms']:.5f}  plain_ms "
              f"{k['plain_ms']:.5f}  bound_ms {k['bound_ms']:.6f} "
              f"({k['bound_by']})  max_abs_err {k['max_abs_err']:.3g} "
              f"against the plain version, tolerance "
              f"{tolerance[k['name']]}")

    tokens = check_reduced_tokens()
    print(f"reduced yi-6b: cpu and cuda tokens identical ({tokens[:2]} ...)")

    # ---- phase 5: the main path at full width ----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(full, torch.Generator(device="cuda")
                           .manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    print(f"yi-6b full width: {M.param_count(params) / 1e9:.3f} B params "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    counters = {"paged_decode_partials": pops.paged_decode_partials,
                "quantize_demote": hops.quantize_blocks,
                "dequantize_reload": hops.dequantize_blocks}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    server, stats, step_s = serve(full, params, "cuda", num_requests=6,
                                  local_slots=10, peer_budget=3 * MiB,
                                  max_batch=4, bs=bs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    eng = server.engine
    served = [h for h in server.handles if h.state == "done"]
    kv = dict(eng.kv_mgr.stats)
    print(f"served {len(served)}/{len(server.handles)} requests, "
          f"{stats.tokens_out} tokens, kv {kv}")
    print(f"fidelity {eng.runtime.stats().get('fid', {})}")
    print(f"launches on the main path: {launches}")
    assert len(served) == len(server.handles) == 6
    assert all(len(h.tokens) == 16 for h in served)
    assert kv["evict_to_peer"] + kv["evict_to_host"] > 0, kv
    assert kv["reload_peer"] + kv["reload_host"] > 0, kv
    assert all(n > 0 for n in launches.values()), launches
    stats.check_clock_identity()
    for h in served:
        assert all(0 <= tok < full.vocab_size for tok in h.tokens)
    decode_ms = 1e3 * float(np.mean(step_s))
    print(f"decode step wall {decode_ms:.2f} ms (mean of {len(step_s)}), "
          f"{stats.tokens_out / wall:.1f} tokens/s wall over {wall:.2f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"simulated (H100/NVLink cost model, not the card): clock "
          f"{stats.clock_s * 1e3:.4f} ms, "
          f"{stats.tokens_out / stats.clock_s:.0f} tokens/s")
    step_ms, busy_ms, top = profile_decode_step(full, params, bs)
    print(f"decode step profile: {step_ms:.2f} ms wall, {busy_ms:.2f} ms "
          f"device-busy ({100 * busy_ms / step_ms:.1f}%)")
    for name, ms in top:
        print(f"  {ms:8.3f} ms/step  {name[:90]}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
