"""Dry-run profiler: the heaviest ops, kernels and collectives of one rank's
program: the port's counterpart of the JAX package's
``repro/launch/audit.py``.

It runs one (arch x shape x mesh) as ``launch.dryrun`` does (rank 0 on
``meta`` tensors in a fake world) and prints the memory split, the
totals, and the top rows by HBM bytes, each keyed by its ``aten`` op and
the port function that issued it (``backward`` where autograd's engine
issued it),
beside the hand-written kernels' calls and cost and the collectives by
the function that called them.  Every number is a count of the program
or a prediction of the hardware model, not a measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.audit --arch qwen2-vl-72b \\
      --shape decode_32k [--mesh pod] [--top 20]
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.launch.op_analysis import count
from repro_torch.launch.specs import build_step

GIB = 2 ** 30


def report(c, top: int) -> str:
    """The audit's text for the counts ``c`` (an ``OpCount``)."""
    m = c.mem
    lines = [f"memory/rank: {m['total_bytes'] / GIB:.2f} GiB  (arg "
             f"{m['argument_bytes'] / GIB:.2f} + temp "
             f"{m['temp_bytes'] / GIB:.2f} + out "
             f"{m['output_bytes'] / GIB:.2f} - alias "
             f"{m['alias_bytes'] / GIB:.2f})",
             "",
             f"totals: aten dot {c.dot_flops / 1e12:.2f} TFLOP  hbm "
             f"{c.hbm_bytes / GIB:.1f} GiB  kernels {c.kernel_flops / 1e12:.2f}"
             f" TFLOP / {c.kernel_bytes / GIB:.1f} GiB  coll "
             f"{c.collective_bytes / GIB:.2f} GiB",
             "collectives: " + "  ".join(
                 f"{k}={v['bytes'] / GIB:.2f}GiB/n={v['calls']}"
                 for k, v in c.collectives.items() if v["calls"])]
    lines += ["", "kernels (cost functions):"]
    for name, k in sorted(c.kernels.items(), key=lambda kv: -kv[1]["bytes"]):
        lines.append(f"  {k['bytes'] / GIB:8.2f}GiB {k['flops'] / 1e12:9.3f}"
                     f"TFLOP x{k['launches']:5d} {name} ({k['dtype']})")
    rows = sorted(c.ops.items(), key=lambda kv: -kv[1][2])[:top]
    lines += ["", f"top {len(rows)} HBM-traffic rows (aten op, port "
                  f"function):"]
    for (op, site), (calls, flops, nbytes) in rows:
        lines.append(f"  {nbytes / GIB:8.2f}GiB x{calls:5d} {op:26s} "
                     f"{site[:52]:52s} {flops / 1e12:.3f} TFLOP")
    colls = sorted(c.collective_sites.items(), key=lambda kv: -kv[1][1])
    lines += ["", f"top {min(top, len(colls))} collectives (operand bytes):"]
    for (op, site), (calls, nbytes) in colls[:top]:
        lines.append(f"  {nbytes / GIB:8.3f}GiB x{calls:5d} {op:22s} {site}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--harvest-inplace", action="store_true")
    ap.add_argument("--peer-fraction", type=float, default=0.0)
    args = ap.parse_args()

    multi_pod = args.mesh == "multipod"
    fake_world(512 if multi_pod else 256)
    try:
        rules = make_rules(make_production_mesh(multi_pod=multi_pod))
        fn, fargs = build_step(get_config(args.arch),
                               INPUT_SHAPES[args.shape], rules,
                               harvest_inplace=args.harvest_inplace,
                               peer_fraction=args.peer_fraction)
        _, c = count(fn, fargs)
    finally:
        dist.destroy_process_group()
    print(report(c, args.top))


if __name__ == "__main__":
    main()
