"""Probe how often the profiler's trace of a short call comes back without
a device row, on one CUDA card, and whether the kernels it does record lie
inside the trace's capture window.

    python3 tools/probe_trace_window.py [--rounds 300] [--gap-ms 200]

Each round keeps the card busy for about ``--gap-ms`` (large products, as a
serving loop between two profiles), then takes three traces of one
eviction-like call (the block gather K6 of 24 layers' rows into a payload,
quantize-on-demote K2 of one row, the payload's copy to the host), as
``chip_smoke.py`` traces them (CUDA activity only):

  * ``bare``: the calls alone in the window (``chip_smoke.trace_rows``
    before it padded its window);
  * ``padded``: the card synchronised and the host idle for ``--pad-ms``
    on both sides of the calls, inside the window;
  * ``cpu``: bare, with CPU activity recorded too.

For every trace it counts the device rows, and for a trace with rows the
offset of the first device row's start from the first launch or copy
call's start: it is a few microseconds when the card's and the
host's clocks agree.  Prints one JSON line: per kind the empty traces,
the rounds they fell in, and the offsets' spread over the run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def take(fn, cpu, pad_s):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=acts) as prof:
            if pad_s:
                torch.cuda.synchronize()
                time.sleep(pad_s)
            fn()
            torch.cuda.synchronize()
            if pad_s:
                time.sleep(pad_s)
    events = prof.events()
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and e.time_range.elapsed_us() > 0]
    runtime = [e for e in events if e.name.startswith("cuda")
               and ("Launch" in e.name or "Memcpy" in e.name)]
    offset = None
    if dev and runtime:
        offset = (min(e.time_range.start for e in dev)
                  - min(e.time_range.start for e in runtime))
    return len(dev), offset


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--gap-ms", type=float, default=200.0)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_trace_window: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.harvest_copy import ops as hops

    layers, slots, elems = 24, 64, 16 * 8 * 128
    pool = torch.randn(layers * slots, elems, device="cuda",
                       dtype=torch.bfloat16)
    row_ids = np.arange(layers, dtype=np.int32) * slots
    dev_row = torch.zeros(1, dtype=torch.int32, device="cuda")
    host_row = np.zeros(1, np.int32)

    def evict():
        out = pool.new_empty(layers, elems)
        hops.gather_blocks(pool, row_ids + 5, out=out)
        vals, _ = hops.quantize_blocks(out.view(1, -1).contiguous(), dev_row,
                                       fidelity="int8", host_ids=host_row)
        return vals.cpu()

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    evict()
    torch.cuda.synchronize()
    kinds = {"bare": (False, 0.0), "padded": (False, args.pad_ms / 1e3),
             "cpu": (True, 0.0)}
    res = {k: {"empty_rounds": [], "offsets_us": []} for k in kinds}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        t_gap = time.perf_counter()
        while time.perf_counter() - t_gap < args.gap_ms / 1e3:
            for _ in range(4):
                a @ a
            torch.cuda.synchronize()
        for kind, (cpu, pad_s) in kinds.items():
            n, off = take(evict, cpu, pad_s)
            if n == 0:
                res[kind]["empty_rounds"].append(r)
            elif off is not None:
                res[kind]["offsets_us"].append(off)
    out = {"rounds": args.rounds, "seconds": time.perf_counter() - t0,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    for kind, v in res.items():
        offs = v["offsets_us"]
        out[kind] = {
            "empty": len(v["empty_rounds"]),
            "empty_rounds": v["empty_rounds"][:50],
            "offset_us": None if not offs else {
                "min": min(offs), "median": statistics.median(offs),
                "max": max(offs), "first10": offs[:10], "last10": offs[-10:]},
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
