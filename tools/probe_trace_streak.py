"""Probe runs of profiler traces that come back without a device row, where
``chip_smoke.py`` meets them: its K2/K3 phase, right after K1's.

    python3 tools/probe_trace_streak.py [--rounds 300]

Runs ``chip_smoke.check_paged_decode`` and ``chip_smoke.check_quant`` as
``chip_smoke.main`` calls them, with ``chip_smoke.traced_rows`` replaced by
one that, after an empty trace, tries in turn: the same trace again; one
with CPU activity recorded too; one of 64 calls; one after the card and the
host have been idle for 2 s.  It logs which came back with device rows.
Then it takes ``--rounds`` single-call traces of K2 in a row, as
``check_quant`` takes its first, and counts the empty ones and their runs.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    args = ap.parse_args()
    import dataclasses
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_trace_streak: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from probe_trace_window import take
    from repro_torch.kernels import build
    from repro_torch.kernels.harvest_copy import ops as hops

    t0 = time.perf_counter()
    build.build_all()
    log = []
    real = cs.traced_rows

    def rows_of(fn, iters, pad_s=cs.TRACE_PAD_S):
        return [(n, t) for n, t in cs.trace_rows(fn, iters, pad_s) if t > 0]

    def traced(fn, iters):
        rows = rows_of(fn, iters)
        if rows:
            return rows
        entry = {"t_s": time.perf_counter() - t0, "iters": iters}
        got = None
        for name, probe in (
                ("same", lambda: rows_of(fn, iters)),
                ("cpu", lambda: take(fn, True, cs.TRACE_PAD_S)[0]),
                ("many", lambda: rows_of(fn, 64)),
                ("idle_2s", lambda: (torch.cuda.synchronize(),
                                     time.sleep(2.0),
                                     rows_of(fn, iters))[-1])):
            res = probe()
            entry[name] = len(res) if isinstance(res, list) else res
            if got is None and isinstance(res, list) and res:
                got = res if name != "many" else None
        log.append(entry)
        print(f"  empty trace: {entry}", file=sys.stderr, flush=True)
        return got if got is not None else real(fn, iters)

    cs.traced_rows = traced
    torch.backends.cuda.matmul.allow_tf32 = False
    yi, moe = cs.get_config("yi-6b"), cs.get_config("qwen2-moe")
    danube = cs.get_config("h2o-danube-3-4b")
    nemotron = cs.get_config("nemotron-4-15b")
    command_r = cs.get_config("command-r-35b")
    llama4 = dataclasses.replace(cs.get_config(cs.LLAMA4),
                                 num_layers=cs.LLAMA4_LAYERS)
    qwen2_vl = dataclasses.replace(cs.get_config(cs.QWEN2_VL),
                                   num_layers=cs.QWEN2_VL_LAYERS)
    dbrx = dataclasses.replace(cs.get_config(cs.DBRX),
                               num_layers=cs.DBRX_LAYERS)
    zamba2, musicgen = cs.get_config(cs.ZAMBA2), cs.get_config(cs.MUSICGEN)
    cs.check_paged_decode(yi, 8, more=[nemotron, command_r,
                                       cs.get_config(cs.LLAMA4),
                                       cs.get_config(cs.QWEN2_VL), zamba2,
                                       musicgen], chunked=[llama4])
    t_k1 = time.perf_counter() - t0
    error = None
    try:
        cs.check_quant([(yi, 8), (moe, 8), (danube, 16), (llama4, 16),
                        (command_r, 8), (nemotron, 8), (qwen2_vl, 8),
                        (dbrx, 8), (zamba2, 8)])
    except RuntimeError as exc:
        error = str(exc)
    t_k2 = time.perf_counter() - t0

    elems = cs.block_elems(yi, 8)
    pool = torch.randn(64, elems, device="cuda")
    dev_ids = torch.zeros(1, dtype=torch.int32, device="cuda")
    host = np.zeros(1, np.int32)

    def quant():
        return hops.quantize_blocks(pool, dev_ids, fidelity="int8",
                                    host_ids=host)

    quant()
    empty, runs, run = [], [], 0
    for r in range(args.rounds):
        if not rows_of(quant, 1):
            empty.append(r)
            run += 1
        elif run:
            runs.append(run)
            run = 0
    if run:
        runs.append(run)
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": cs.card_line(), "k1_phase_end_s": t_k1,
        "k2_phase_end_s": t_k2, "k2_phase_error": error,
        "empty_in_phases": log,
        "rounds": args.rounds, "empty_rounds": empty[:100],
        "empty_runs": runs, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
