"""Dry run over the production meshes: one rank's program for every
(architecture x input shape), run once on ``meta`` tensors, its memory,
operations, bytes and collectives counted (``launch.op_analysis``), and
one JSONL record appended per run: the port's counterpart of the JAX
package's ``repro/launch/dryrun.py``.

The JAX package lowers and compiles each pair over 256 or 512 placeholder
devices.  The port's ranks are processes: rank 0's program runs here in a
world of 256 or 512 ranks of torch's fake process group (every collective
returns at once without moving anything), where ``launch.mesh``'s
``make_production_mesh`` and ``make_rules`` build their groups unchanged.
Every split ``train_spec`` takes divides evenly, so the ranks' programs
are alike and rank 0's stands for each.  Nothing is allocated or
computed, so it needs neither ``nvcc`` nor a card.  The roofline and the
harvest record take the port's hardware model, ``core.tiers.H100_NVLINK``;
every number of a record is a prediction of that model, not a
measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [--force]
  python -m repro_torch.launch.dryrun --table --out results/dryrun_torch.jsonl
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, dryrun_pairs, get_config
from repro_torch.core.tiers import H100_NVLINK
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.launch.op_analysis import count
from repro_torch.launch.specs import build_step


def model_flops(cfg, shape) -> float:
    pc = cfg.param_counts()
    n = pc["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token/request


def harvest_record(cfg, peer_fraction: float) -> dict:
    """Tier-link context for a dry-run record, via the HarvestRuntime facade:
    what one expert / one KV block costs to reload from each non-local tier
    on the hardware model (the runtime's TransferEngine, the single source
    of transfer times)."""
    from repro_torch.core.runtime import HarvestRuntime
    from repro_torch.core.tiers import Tier, expert_bytes, kv_block_bytes

    rt = HarvestRuntime(hardware=H100_NVLINK)
    out = {"hardware": H100_NVLINK.name, "peer_fraction": peer_fraction}
    units = {}
    if cfg.moe is not None:
        units["expert"] = expert_bytes(cfg)
    if cfg.has_kv_cache:
        units["kv_block_16"] = kv_block_bytes(cfg, 16)
    for name, nbytes in units.items():
        peer = rt.transfers.transfer(name, nbytes, Tier.PEER_HBM,
                                     Tier.LOCAL_HBM, client="dryrun").seconds
        host = rt.transfers.transfer(name, nbytes, Tier.HOST_DRAM,
                                     Tier.LOCAL_HBM, client="dryrun").seconds
        out[name] = {"bytes": nbytes, "peer_reload_s": peer,
                     "host_reload_s": host, "peer_speedup": host / peer}
    return out


def roofline(c, hw=H100_NVLINK) -> dict:
    """The three terms of a count ``c`` (``op_analysis.OpCount``) on the
    hardware model ``hw``: its ``aten`` and kernel flops over the peak
    rate, its bytes over the memory rate, its collectives' bytes over the
    peer link; and the largest."""
    terms = dict(
        compute_term_s=(c.dot_flops + c.kernel_flops) / hw.peak_flops,
        memory_term_s=(c.hbm_bytes + c.kernel_bytes) / hw.hbm_bw,
        collective_term_s=c.collective_bytes / hw.peer_link.bandwidth)
    return dict(terms, hardware=hw.name, bottleneck=max(
        terms, key=terms.get).replace("_term_s", ""))


def fake_world(size: int, rank: int = 0) -> None:
    """Join a world of ``size`` ranks as ``rank`` on torch's fake process
    group (no card, no network; a world already joined of another shape
    is left first)."""
    # importing the module registers the backend "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)


def run_one(arch: str, shape_name: str, mesh_kind: str,
            harvest_inplace: bool = False, peer_fraction: float = 0.0,
            rank: int = 0) -> dict:
    """One rank's program of ``(arch, shape_name)`` on the ``mesh_kind``
    mesh ("pod" or "multipod"), counted; returns the record (``ok``
    False and ``error`` where it raised)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    multi_pod = mesh_kind == "multipod"
    n_dev = 512 if multi_pod else 256
    fake_world(n_dev, rank)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(mesh)
    hw = H100_NVLINK
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "devices": n_dev, "rank": rank,
           "harvest_inplace": harvest_inplace,
           "peer_fraction": peer_fraction, "ok": False,
           "harvest": harvest_record(cfg, peer_fraction)}
    t0 = time.time()
    try:
        fn, args = build_step(cfg, shape, rules,
                              harvest_inplace=harvest_inplace,
                              peer_fraction=peer_fraction)
        t_build = time.time() - t0
        _, c = count(fn, args)
        t_count = time.time() - t0 - t_build
        flops_dev = c.dot_flops + c.kernel_flops
        bytes_dev = c.hbm_bytes + c.kernel_bytes
        mf_dev = model_flops(cfg, shape) / n_dev
        rec.update(
            ok=True, build_s=round(t_build, 2), count_s=round(t_count, 2),
            mem=dict(c.mem, fits=c.mem["total_bytes"] <= hw.hbm_bytes,
                     hbm_bytes=hw.hbm_bytes),
            cost=dict(flops_per_device=flops_dev, bytes_per_device=bytes_dev,
                      dot_flops_aten=c.dot_flops, hbm_bytes_aten=c.hbm_bytes,
                      kernel_flops=c.kernel_flops,
                      kernel_bytes=c.kernel_bytes, kernels=c.kernels),
            collectives=dict({k: v["bytes"] for k, v in
                              c.collectives.items()},
                             counts={k: v["calls"] for k, v in
                                     c.collectives.items()}),
            roofline=dict(
                roofline(c, hw), model_flops_per_device=mf_dev,
                useful_flops_ratio=(mf_dev / flops_dev) if flops_dev else None,
            ),
        )
    except Exception as e:  # noqa: BLE001 -- a dry-run failure is a record
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def _cell(rec) -> str:
    if rec is None:
        return "not run"
    if not rec.get("ok"):
        return rec.get("error", "?").split(":")[0]
    m, r = rec["mem"], rec["roofline"]
    return (f"{m['total_bytes'] / 2 ** 30:.2f} GiB "
            f"{'fits' if m['fits'] else 'does not fit'}; "
            f"{r['compute_term_s'] * 1e3:,.1f} / "
            f"{r['memory_term_s'] * 1e3:,.1f} / "
            f"{r['collective_term_s'] * 1e3:,.1f} ms, {r['bottleneck']}")


def table(path) -> str:
    """A markdown table of the records in ``path`` (the last of each
    (arch, shape, mesh)): per pair and mesh the GiB a rank, whether it
    fits the card, the compute / memory / collective terms and the
    bottleneck."""
    recs = {}
    for line in Path(path).read_text().splitlines():
        r = json.loads(line)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    rows = ["| arch | shape | pod (16 x 16): GiB a rank; compute / memory "
            "/ collective ms, bottleneck | multi-pod (2 x 16 x 16) |",
            "|---|---|---|---|"]
    for arch, shape in dryrun_pairs():
        rows.append(f"| {arch} | {shape} | "
                    + " | ".join(_cell(recs.get((arch, shape, m)))
                                 for m in ("pod", "multipod")) + " |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--harvest-inplace", action="store_true")
    ap.add_argument("--peer-fraction", type=float, default=0.0)
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--table", action="store_true",
                    help="print --out's records as a markdown table")
    args = ap.parse_args()
    if args.table:
        print(table(args.out))
        return

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if args.all:
        done = set()
        if out_path.exists() and not args.force:
            for line in out_path.read_text().splitlines():
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("harvest_inplace", False)))
        todo = [(a, s, m) for m in meshes for (a, s) in dryrun_pairs()
                if (a, s, m, args.harvest_inplace) not in done]
        print(f"{len(todo)} rank programs to run ({len(done)} cached)")
        for i, (a, s, m) in enumerate(todo):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m, "--out", args.out]
            if args.harvest_inplace:
                cmd.append("--harvest-inplace")
            if args.peer_fraction:
                cmd += ["--peer-fraction", str(args.peer_fraction)]
            print(f"[{i + 1}/{len(todo)}] {a} x {s} x {m}", flush=True)
            try:
                subprocess.run(cmd, timeout=args.timeout, check=False)
            except subprocess.TimeoutExpired:
                with out_path.open("a") as f:
                    f.write(json.dumps({
                        "arch": a, "shape": s, "mesh": m, "ok": False,
                        "error": f"timeout after {args.timeout}s"}) + "\n")
        return

    if not (args.arch and args.shape) or len(meshes) != 1:
        ap.error("--arch and --shape and one --mesh, or --all")
    rec = run_one(args.arch, args.shape, meshes[0],
                  harvest_inplace=args.harvest_inplace,
                  peer_fraction=args.peer_fraction)
    with out_path.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    status = "OK" if rec["ok"] else f"FAIL: {rec.get('error', '?')}"
    print(f"{args.arch} x {args.shape} x {meshes[0]}: {status} "
          f"({rec['wall_s']}s)")
    if rec["ok"]:
        r, mem = rec["roofline"], rec["mem"]
        print(f"  mem/rank: {mem['total_bytes'] / 2 ** 30:.2f} GiB "
              f"({'fits' if mem['fits'] else 'does not fit'} "
              f"{mem['hbm_bytes'] / 2 ** 30:.0f} GiB)  "
              f"bottleneck: {r['bottleneck']}")
        print(f"  terms: compute {r['compute_term_s'] * 1e3:.2f}ms  "
              f"memory {r['memory_term_s'] * 1e3:.2f}ms  "
              f"collective {r['collective_term_s'] * 1e3:.2f}ms "
              f"(predicted on {r['hardware']})")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
