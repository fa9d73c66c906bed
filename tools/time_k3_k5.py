"""Time dequantize-on-reload (K3) and the reload copy (K5) of the
``repro_torch`` package under ``--src`` on one CUDA card, at the shapes the
three full-width paths give them: K3 on one demoted block of yi-6b,
qwen2-moe and h2o-danube-3-4b (int8, one row, its id on the device with a
host mirror, as the engine's ``_degrade`` passes it; rows cycling through
a pool larger than the L2), K5 at each model's per-pool reload shape (one
slot's block of every layer from a staging pool of alternating k and v
rows, host ids, as the engine's ``_copy_slot`` passes them; slots cycling
through a 128-slot pool) beside ``index_select`` + ``index_copy_`` with
device ids.  Each wrapper is called as the engine calls it, the same way
for every tree, and each is held to its plain version first.

One rule for every tree: a call's device time comes from a profiler trace
of 200 calls that holds the kernel's own row exactly once a call (and
every other row a whole number of times a call); a trace that lost rows
is taken again, up to three times, and never used.  The time is split
into the kernel's own rows, the ids' copies from host to card, and the
rest.  Prints one JSON line.  Run for two checkouts in one call, it holds
their kernels side by side on the same inputs:

    python3 tools/time_k3_k5.py                      # this checkout's src
    python3 tools/time_k3_k5.py --src other/checkout/src
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (model, block size) of the three full-width paths
PATHS = (("yi-6b", 8), ("qwen2-moe", 8), ("h2o-danube-3-4b", 16))
ITERS = 200


def whole_trace(fn, iters, kernel=None):
    """[(name, launches per call, device ms per call)] of ``iters`` calls of
    ``fn`` from a trace in which ``kernel`` (if given) ran once a call and
    every row a whole number of times a call (``chip_smoke.whole_trace``)."""
    import chip_smoke as cs

    def once(rows):
        return sum(c for n, c, _ in rows if kernel and kernel in n) \
            == (1 if kernel else 0)
    return cs.whole_trace(fn, iters, once, warmup=5)


def split(rows, kernel):
    """The kernel's own ms, the ids' host-to-device copies' ms, the rest's
    ms, and the rows' names with their launches per call."""
    own = sum(t for n, _, t in rows if kernel in n)
    h2d = sum(t for n, _, t in rows if "HtoD" in n)
    return dict(kernel_ms=own, ids_copy_ms=h2d,
                other_ms=sum(t for _, _, t in rows) - own - h2d,
                rows=[(n[:60], c) for n, c, _ in rows])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    src = Path(ap.parse_args().src).resolve()
    sys.path.insert(0, str(src))
    # imported first, so that chip_smoke's imports bind this tree's package
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(src)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k3_k5: no CUDA card visible", file=sys.stderr)
        return 2
    hops = cs.hops
    out = dict(src=str(src), card=cs.card_line())
    rng = np.random.default_rng(cs.SEED + 9)
    for arch, bs in PATHS:
        cfg = cs.get_config(arch)
        # K3: one (1, elems) row a call, int8, as _degrade reloads a block
        elems = cs.block_elems(cfg, bs)
        pool = torch.from_numpy(rng.normal(size=(64, elems)).astype(
            np.float32)).cuda()
        dev = [torch.tensor([i], dtype=torch.int32, device="cuda")
               for i in range(64)]
        host = [np.asarray([i], np.int32) for i in range(64)]
        vals, scales = hops.quantize_blocks(pool, host[5], fidelity="int8")
        dst = torch.zeros_like(pool)
        nxt = [0]

        def dequant():
            i = nxt[0] = (nxt[0] + 1) % 64
            return hops.dequantize_blocks(dst, vals, scales, dev[i],
                                          fidelity="int8", host_ids=host[i])

        for i in (0, 63):
            ref = hops.dequantize_blocks_plain(dst.clone(), vals, scales,
                                               host[i], "int8")
            got = hops.dequantize_blocks(dst.clone(), vals, scales, dev[i],
                                         fidelity="int8", host_ids=host[i])
            assert torch.equal(got, ref), f"K3 at {arch}"
        bound_ms, _ = cs.cost_bound(hops.dequantize_blocks_cost(1, elems, elems,
                                                            4))
        out[f"k3_{arch}"] = dict(
            elems=elems, bound_ms=bound_ms,
            **split(whole_trace(dequant, ITERS, "dequantize_kernel"),
                    "dequantize_kernel"))
        del pool, dst, vals, scales

        # K5: one slot's block of every layer, staging rows into one pool
        L = cs.M.num_kv_layers(cfg)
        row = bs * cfg.num_kv_heads * cfg.resolved_head_dim
        n_slots = 128
        pool = torch.from_numpy(rng.normal(size=(L * n_slots, row)).astype(
            np.float32)).cuda()
        staging = torch.from_numpy(rng.normal(size=(2 * L, row)).astype(
            np.float32)).cuda()
        layer_rows = np.arange(L, dtype=np.int32) * n_slots
        k_rows = 2 * np.arange(L, dtype=np.int32)
        dev_dst = [torch.from_numpy(layer_rows + s).long().cuda()
                   for s in range(n_slots)]
        dev_k = torch.from_numpy(k_rows).long().cuda()

        def copy():
            s = nxt[0] = (nxt[0] + 1) % n_slots
            return hops.copy_blocks(staging, pool, k_rows, layer_rows + s)

        def library():
            s = nxt[0] = (nxt[0] + 1) % n_slots
            return pool.index_copy_(0, dev_dst[s],
                                    torch.index_select(staging, 0, dev_k))

        for s in (0, 1, n_slots - 1):
            got = hops.copy_blocks(staging, pool.clone(), k_rows,
                                   layer_rows + s)
            ref = hops.copy_blocks_plain(staging, pool.clone(), k_rows,
                                         layer_rows + s)
            assert torch.equal(got, ref), f"K5 at {arch}"
            del got, ref
        lib = whole_trace(library, ITERS)
        bound_ms, _ = cs.cost_bound(hops.copy_blocks_cost(L, 4 * row))
        out[f"k5_{arch}"] = dict(
            rows_moved=L, row_bytes=4 * row, bound_ms=bound_ms,
            library_ms=sum(t for _, _, t in lib),
            **split(whole_trace(copy, ITERS, "copy_rows_kernel"),
                    "copy_rows_kernel"))
        del pool, staging
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
