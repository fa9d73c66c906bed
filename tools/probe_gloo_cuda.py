"""Does this build's gloo take CUDA tensors, and what does a collective of
the sharded decode step cost over gloo on one card?

    python3 tools/probe_gloo_cuda.py

Two ranks on the one card (gloo: NCCL refuses two ranks on one device).
Each tries ``dist.all_reduce`` on a CUDA tensor as it is, then times, at
the shapes of the sharded decode step's collectives, that call (where it
was taken: what ``repro_torch.core.collectives.all_reduce`` does) beside
the same reduction with the operand copied to the host and back by hand:
yi-6b's row maxima (4 rows, 8 kv heads, a group of 4) and its sums of l
and acc in one buffer (hd 128), and phi-tiny-moe's combined rows (4 x
2,304, f32).  Prints one JSON line per rank: host ms
per call (each call ends synchronised, as the step's next op needs its
result), the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.mesh import launch  # noqa: E402

SHAPES = {"m (4, 8, 4)": ((4, 8, 4), "max"),
          "l and acc (4 * 8 * 4 * 129,)": ((4 * 8 * 4 * 129,), "sum"),
          "moe rows (4, 2304)": ((4, 2304), "sum")}
ITERS = 200


def _time(fn, iters=ITERS):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def probe(rank, world):
    torch.cuda.set_device(0)
    out = {"rank": rank}
    x = torch.full((8,), float(rank + 1), device="cuda")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out["direct"] = f"taken: {x[0].item()} (want {world * (world + 1) / 2})"
        direct = True
    except Exception as e:      # noqa: BLE001  (the answer is the error)
        out["direct"] = f"refused: {type(e).__name__}: {str(e)[:300]}"
        direct = False
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    for name, (shape, op) in SHAPES.items():
        t = torch.randn(shape, device="cuda")

        def by_hand():
            host = t.cpu()
            dist.all_reduce(host, ops[op])
            t.copy_(host)

        row = {"host_copy_ms": _time(by_hand)}
        if direct:
            row["direct_ms"] = _time(lambda: dist.all_reduce(t, ops[op]))
        out[name] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA card visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for row in launch(probe, 2, timeout=300):
        print(json.dumps(dict(row, card=card, torch=torch.__version__)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
