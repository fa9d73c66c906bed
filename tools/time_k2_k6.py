"""Time quantize-on-demote (K2) and the block gather (K6) of the
``repro_torch`` package under ``--src`` on one CUDA card, at the shapes the
three full-width paths give them, with ``chip_smoke.py``'s timing: K2 on
one demoted block of yi-6b, qwen2-moe and h2o-danube-3-4b (int8, rows
cycling through a pool larger than the L2), K6 at each model's per-pool
eviction shape (one slot's block of every layer, slots cycling through a
128-slot pool) beside ``index_select`` with device ids and, where the
tree's K6 takes its ids in the launch, beside the same kernel reading them
from a device table.  Each wrapper is called as that tree's engine calls
it, and each is held to its plain version first.  A call's device time
is split, from the profiler's trace, into the ids' copies between host
and card and the rest (kernels and memsets).  Prints one JSON line.  Run for two checkouts in one call, it
holds their kernels side by side on the same inputs:

    python3 tools/time_k2_k6.py                      # this checkout's src
    python3 tools/time_k2_k6.py --src other/checkout/src
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (model, block size) of the three full-width paths
PATHS = (("yi-6b", 8), ("qwen2-moe", 8), ("h2o-danube-3-4b", 16))


def split_rows(cs, fn, iters):
    """(device ms per call without the ids' copies, the copies' ms, the
    rows' names) of ``iters`` calls of ``fn``."""
    rows = cs.trace_rows(fn, iters)
    copies = sum(t for n, t in rows if "Memcpy" in n)
    return (sum(t for n, t in rows if "Memcpy" not in n), copies,
            [n[:60] for n, t in rows if t > 0])


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
        print("time_k2_k6: no CUDA card visible", file=sys.stderr)
        return 2
    hops = cs.hops
    mirror = "host_ids" in inspect.signature(hops.gather_blocks).parameters
    out = dict(src=str(src), card=cs.card_line(), host_mirror=mirror)
    rng = np.random.default_rng(cs.SEED + 8)
    for arch, bs in PATHS:
        cfg = cs.get_config(arch)
        # K2: one (1, elems) row a call, int8, as _degrade demotes a block
        elems = cs.block_elems(cfg, bs)
        pool = torch.from_numpy(rng.normal(size=(64, elems)).astype(
            np.float32)).cuda()
        dev = [torch.tensor([i], dtype=torch.int32, device="cuda")
               for i in range(64)]
        nxt = [0]

        def quant():
            i = nxt[0] = (nxt[0] + 1) % 64
            if mirror:      # device ids and their mirror, as _degrade
                return hops.quantize_blocks(pool, dev[i], fidelity="int8",
                                            host_ids=np.asarray([i]))
            return hops.quantize_blocks(pool, np.asarray([i], np.int32),
                                        fidelity="int8")

        for i in (0, 63):
            got = hops.quantize_blocks(pool, dev[i], fidelity="int8")
            ref = hops.quantize_blocks_plain(pool, dev[i], "int8")
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                               ref[1])
        for _ in range(5):
            quant()
        own, copies, names = split_rows(cs, quant, 200)
        bound_ms, _ = cs.cost_bound(hops.quantize_blocks_cost(1, elems, elems,
                                                          4))
        out[f"k2_{arch}"] = dict(elems=elems, ms=own, ids_copy_ms=copies,
                                 rows=names, bound_ms=bound_ms)
        del pool

        # K6: one slot's block of every layer from one pool
        L = cs.M.num_kv_layers(cfg)
        row = bs * cfg.num_kv_heads * cfg.resolved_head_dim
        n_slots = 128
        pool = torch.from_numpy(rng.normal(size=(L * n_slots, row)).astype(
            np.float32)).cuda()
        layer_rows = np.arange(L, dtype=np.int32) * n_slots
        table = torch.from_numpy(layer_rows[None, :] + np.arange(
            n_slots, dtype=np.int32)[:, None]).cuda()
        payload = torch.empty((L, 2, row), device="cuda")
        half = payload[:, 0]

        def gather():
            s = nxt[0] = (nxt[0] + 1) % n_slots
            if mirror:      # as the engine's eviction calls it now
                return hops.gather_blocks(pool, layer_rows + s, out=half)
            return hops.gather_blocks(pool, layer_rows + s)

        def device_ids():
            # the same kernel reading its ids from a device table
            s = nxt[0] = (nxt[0] + 1) % n_slots
            hops._launch_mover(
                "gather_blocks", hops._movers().harvest_gather_rows,
                pool.data_ptr(), table[s].data_ptr(), None, half.data_ptr(),
                L, 4 * row, 8 * row)

        def library():
            s = nxt[0] = (nxt[0] + 1) % n_slots
            return torch.index_select(pool, 0, table[s])

        for s in (0, 1, n_slots - 1):
            got = hops.gather_blocks(pool, layer_rows + s)
            assert torch.equal(got, hops.gather_blocks_plain(
                pool, layer_rows + s))
        for fn in (gather, library):
            for _ in range(5):
                fn()
        own, copies, names = split_rows(cs, gather, 200)
        lib, _, _ = split_rows(cs, library, 200)
        bound_ms, _ = cs.cost_bound(hops.gather_blocks_cost(L, 4 * row))
        out[f"k6_{arch}"] = dict(rows_moved=L, row_bytes=4 * row, ms=own,
                                 ids_copy_ms=copies, rows=names,
                                 index_select_ms=lib, bound_ms=bound_ms)
        if mirror:
            for _ in range(5):
                device_ids()
            out[f"k6_{arch}"]["device_ids_ms"], _, _ = split_rows(
                cs, device_ids, 200)
        del pool, payload, half
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
