"""Does this build's gloo take CUDA tensors, and what does a collective of
the sharded decode step cost over gloo on one card?

    python3 tools/probe_gloo_cuda.py [--training]

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

With ``--training``: four ranks on the card, the mesh (data 2, model 2)
of the sharded training step.  Each tries the collectives that training
calls on CUDA tensors as they are (``all_gather`` into a list,
``all_gather_into_tensor``, ``reduce_scatter_tensor``) and times, over
its ``data`` pair, at full-width phi-tiny-moe's shapes: a layer's
attention weights gathered (bf16, half of 2,304 rows a rank) and their
gradient reduce-scattered in f32, the rank's 8 experts' three weights
likewise, and the MoE layer's (8,192, 2,304) f32 rows summed over its
``model`` pair; the reduce-scatter both ways, ``reduce_scatter_tensor``
(where taken) and ``all_reduce`` then the rank's slice.
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
    for _ in range(min(10, iters)):
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


#: (what, full shape, dtype, the dim split over ``data``)
TRAIN_SHAPES = {
    "attention weights (2304, 5184) bf16": ((2304, 5184), torch.bfloat16, 0),
    "8 experts' wi, wg, wo (8, 3, 2304, 915) bf16": (
        (8, 3, 2304, 915), torch.bfloat16, 2)}
TRAIN_ITERS = 10


def _try(fn):
    try:
        fn()
        torch.cuda.synchronize()
        return True, "taken"
    except Exception as e:      # noqa: BLE001  (the answer is the error)
        return False, f"refused: {type(e).__name__}: {str(e)[:300]}"


def probe_training(rank, world):
    """One rank of ``--training``: (data i, model j) = divmod(rank, 2)."""
    torch.cuda.set_device(0)
    i, j = divmod(rank, 2)
    pairs = {}
    for name, members in (("data", [[0, 2], [1, 3]]),
                          ("model", [[0, 1], [2, 3]])):
        for m in members:
            g = dist.new_group(m)
            if rank in m:
                pairs[name] = g
    data, model = pairs["data"], pairs["model"]
    out = {"rank": rank, "coords": {"data": i, "model": j}}
    x = torch.full((4, 8), float(rank + 1), device="cuda")
    whole = torch.empty((8, 8), device="cuda")
    part = torch.empty((2, 8), device="cuda")
    ok = {}
    for what, fn in (
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(2)], x, group=data)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                whole, x, group=data)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                part, x, group=data))):
        ok[what], out[what] = _try(fn)
    for name, (shape, dtype, dim) in TRAIN_SHAPES.items():
        full = torch.randn(shape, device="cuda").to(dtype)
        mine = full.chunk(2, dim)[i].contiguous()
        grad = full.float()

        def gather():
            parts = [torch.empty_like(mine) for _ in range(2)]
            dist.all_gather(parts, mine, group=data)
            torch.cat(parts, dim)

        def by_all_reduce():
            g = grad.clone()
            dist.all_reduce(g, group=data)
            g.chunk(2, dim)[i].contiguous()

        def by_reduce_scatter():
            g = grad.movedim(dim, 0).contiguous()
            o = torch.empty((g.shape[0] // 2,) + g.shape[1:], device="cuda")
            dist.reduce_scatter_tensor(o, g, group=data)

        row = {"gather_ms": _time(gather, TRAIN_ITERS),
               "all_reduce_and_slice_ms": _time(by_all_reduce, TRAIN_ITERS)}
        if ok["reduce_scatter_tensor"]:
            row["reduce_scatter_tensor_ms"] = _time(by_reduce_scatter,
                                                    TRAIN_ITERS)
        out[name] = row
    rows = torch.randn((8192, 2304), device="cuda")
    out["moe rows (8192, 2304) f32 over model"] = {"all_reduce_ms": _time(
        lambda: dist.all_reduce(rows, group=model), TRAIN_ITERS)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA card visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    training = "--training" in sys.argv[1:]
    fn, n = (probe_training, 4) if training else (probe, 2)
    for row in launch(fn, n, timeout=600):
        print(json.dumps(dict(row, card=card, torch=torch.__version__)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
