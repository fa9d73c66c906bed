"""Serving launcher: the port's Harvest engine over a reduced model, on a
CUDA card by default (``--device cpu`` runs the kernels' plain versions on
the CPU).  Flags are those of ``repro.launch.serve`` plus ``--device``;
weights are random, drawn from ``--seed`` with a ``torch.Generator``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --num-requests 16 --scheduler fair --peer-budget-mb 2

Multi-peer topologies (per-device link lanes, topology-aware placement,
timeline-driven pressure when combined with --with-churn --mode async):

  PYTHONPATH=src python -m repro_torch.launch.serve --topology nvlink-mesh-4 \
      --mode async --prefetch --with-churn

Coalesced transfer batching + chunked striping (one setup latency per
link lane per step; objects over --stripe-min-mb ride link-disjoint
sub-lanes with chunk-granular completion):

  PYTHONPATH=src python -m repro_torch.launch.serve --topology v5e-torus-2x2 \
      --coalesce --stripe 4 --prefetch

Request-lifecycle serving (clock-driven arrivals, SLO classes, admission
policies; per-class TTFT/TPOT percentiles + SLO-goodput in the summary):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload poisson \
      --arrival-rate 20000 --tenants latency:2,batch:1 --slo-ms 1.5 \
      --admission deadline --scheduler fair

Harvested prefix cache (radix-trie cross-request KV sharing: retired
prompts publish their blocks, later requests sharing the system prompt
skip that part of prefill — the summary prints the hit rate):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload poisson \
      --prefix-cache --prefix-share 0.8 --scheduler fair

Continuous batching (iteration-level slot refill is on for async mode;
chunked prefill interleaves long prompts with decode steps, and the
speculative-decode seam charges draft/verify windows on the same clock
— the summary prints batch occupancy + bubble time):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload poisson \
      --chunk-prefill-tokens 32 --spec-draft 4 --spec-accept-rate 0.7
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--local-slots", type=int, default=16)
    ap.add_argument("--peer-budget-mb", type=float, default=4.0)
    ap.add_argument("--scheduler", choices=["fcfs", "fair"], default="fcfs")
    ap.add_argument("--durability", choices=["host_backed", "lossy"],
                    default="host_backed")
    ap.add_argument("--with-churn", action="store_true",
                    help="drive revocations from the cluster trace monitor")
    ap.add_argument("--topology", default=None,
                    help="interconnect preset (nvlink-2gpu, nvlink-mesh-4, "
                         "nvlink-mesh-8, pcie-switch-4, v5e-torus-2x2, "
                         "v5e-torus-4x2): per-peer-device link lanes + "
                         "topology/churn-aware placement; default keeps the "
                         "flat 2-device model")
    ap.add_argument("--monitor-interval-us", type=float, default=None,
                    help="drive trace ticks on the simulated transfer "
                         "clock every N microseconds (async mode only; "
                         "default: one tick every 4 scheduler steps)")
    ap.add_argument("--mode", choices=["sync", "async"], default="sync",
                    help="clock mode: legacy pre-summed vs event timeline")
    ap.add_argument("--prefetch", action="store_true",
                    help="cross-step prefetch (implies --mode async)")
    ap.add_argument("--coalesce", action="store_true",
                    help="batch same-lane transfers issued in one step into "
                         "a single submission paying one setup latency "
                         "(implies --mode async)")
    ap.add_argument("--stripe", type=int, default=0, metavar="WAYS",
                    help="stripe objects >= --stripe-min-mb into chunks over "
                         "N link-disjoint sub-lanes with chunk-granular "
                         "completion (implies --coalesce)")
    ap.add_argument("--stripe-chunk-kb", type=int, default=1024,
                    help="stripe chunk size in KiB (default 1024)")
    ap.add_argument("--stripe-min-mb", type=float, default=4.0,
                    help="size floor in MiB below which objects are never "
                         "striped (default 4)")
    ap.add_argument("--workload", default="legacy",
                    choices=["legacy", "poisson", "bursty", "diurnal"],
                    help="arrival process driving the request-lifecycle "
                         "API (requests become visible at their clock "
                         "arrival time); 'legacy' submits everything "
                         "up-front through the compat wrapper")
    ap.add_argument("--arrival-rate", type=float, default=20000.0,
                    help="mean arrival rate in requests per SIMULATED "
                         "second (the transfer-engine clock runs in "
                         "sub-millisecond territory for reduced models)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="TTFT SLO for the latency class in simulated ms "
                         "(e2e SLO is 10x); default: no deadlines")
    ap.add_argument("--tenants", default="throughput:1",
                    help="comma-separated SLO-class mix 'class:weight' "
                         "(classes: latency, throughput, batch), e.g. "
                         "'latency:2,batch:1'")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the harvested prefix cache: retired "
                         "prompts' KV blocks are published into a radix "
                         "trie over the block store and later requests "
                         "sharing the prefix skip that part of prefill")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    metavar="FRAC",
                    help="fraction of each tenant's requests carrying a "
                         "shared system prompt (lifecycle workloads only; "
                         "pairs naturally with --prefix-cache)")
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="shared system-prompt length in tokens "
                         "(default 32)")
    ap.add_argument("--admission", default="all",
                    choices=["all", "headroom", "deadline"],
                    help="admission policy in front of the scheduler")
    ap.add_argument("--chunk-prefill-tokens", type=int, default=None,
                    metavar="N",
                    help="split prefills into resumable chunks of N tokens "
                         "interleaved with decode steps (implies --mode "
                         "async); long prompts stop stalling latency-class "
                         "decodes")
    ap.add_argument("--spec-draft", type=int, default=0, metavar="K",
                    help="speculative-decode seam: charge K draft tokens + "
                         "one verify pass per landed token on the simulated "
                         "clock (0 = off; emitted tokens are unchanged)")
    ap.add_argument("--spec-accept-rate", type=float, default=0.7,
                    help="per-position draft acceptance probability for "
                         "--spec-draft (default 0.7)")
    ap.add_argument("--fidelity-policy", default="off",
                    help="per-SLO-class demotion precision: 'off' keeps "
                         "every demoted block FP16, 'slo' quantizes "
                         "throughput/batch-class blocks to int8 on demote "
                         "(latency class stays bit-exact), 'always' "
                         "quantizes every demotion including shared prefix "
                         "blocks (max capacity, offline fleets)")
    ap.add_argument("--cold-tier", action="store_true",
                    help="add the LOCAL_SSD cold tier below host DRAM: "
                         "reconstructible evictions take the cheaper SSD "
                         "rung instead of LOST, durable write-backs "
                         "overflow host onto SSD (needs --mode async: the "
                         "ladder charges the event timeline)")
    ap.add_argument("--controller", default="off",
                    choices=["off", "stability"],
                    help="closed-loop stability controller: estimates "
                         "arrival/service/KV rates online, computes the "
                         "stability region, and sheds/defers + caps the "
                         "batch + throttles prefetch/harvest appetite "
                         "when the workload leaves it (needs --mode "
                         "async: the control loop ticks on the event "
                         "timeline)")
    ap.add_argument("--ctrl-tick-us", type=float, default=None,
                    metavar="US",
                    help="controller tick period in simulated "
                         "microseconds (default: 8x the weight-pass "
                         "time)")
    ap.add_argument("--ctrl-headroom", type=float, default=None,
                    metavar="FRAC",
                    help="fraction of effective capacity the engaged "
                         "controller keeps free (default 0.15)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model and the KV pool live (default "
                         "cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args()
    if args.monitor_interval_us and not args.with_churn:
        ap.error("--monitor-interval-us needs --with-churn (there is no "
                 "monitor to drive without a cluster trace)")
    if args.monitor_interval_us and args.mode != "async" and not args.prefetch:
        ap.error("--monitor-interval-us needs --mode async: timeline-driven "
                 "pressure fires on the event clock; sync mode keeps the "
                 "legacy every-4-steps drive")
    if not 0.0 <= args.prefix_share <= 1.0:
        ap.error("--prefix-share must be in [0, 1]")
    if args.prefix_share > 0 and args.workload == "legacy":
        ap.error("--prefix-share needs a lifecycle workload (--workload "
                 "poisson|bursty|diurnal): the legacy path draws prompts "
                 "without tenant prompt pools")
    if args.chunk_prefill_tokens is not None and args.chunk_prefill_tokens <= 0:
        ap.error(f"--chunk-prefill-tokens must be positive, got "
                 f"{args.chunk_prefill_tokens}")
    if args.spec_draft < 0:
        ap.error(f"--spec-draft must be >= 0, got {args.spec_draft}")
    if args.spec_draft and not 0.0 <= args.spec_accept_rate <= 1.0:
        ap.error(f"--spec-accept-rate must be in [0, 1], got "
                 f"{args.spec_accept_rate}")
    if args.fidelity_policy not in ("off", "slo", "always"):
        ap.error(f"unknown --fidelity-policy {args.fidelity_policy!r} "
                 "(one of: off, slo, always)")
    if args.cold_tier and args.mode != "async" and not (
            args.prefetch or args.coalesce or args.stripe
            or args.chunk_prefill_tokens is not None):
        ap.error("--cold-tier needs --mode async: the SSD rung of the "
                 "eviction ladder charges the event timeline")
    if args.controller != "off" and args.mode != "async" and not (
            args.prefetch or args.coalesce or args.stripe
            or args.chunk_prefill_tokens is not None):
        ap.error("--controller stability needs --mode async: the control "
                 "loop ticks on the event timeline")
    if args.controller == "off" and (args.ctrl_tick_us is not None
                                     or args.ctrl_headroom is not None):
        ap.error("--ctrl-tick-us/--ctrl-headroom need --controller "
                 "stability (there is no control loop to configure)")
    if args.ctrl_tick_us is not None and args.ctrl_tick_us <= 0:
        ap.error(f"--ctrl-tick-us must be positive, got "
                 f"{args.ctrl_tick_us}")
    if args.ctrl_headroom is not None \
            and not 0.0 <= args.ctrl_headroom < 0.9:
        ap.error(f"--ctrl-headroom must be in [0, 0.9), got "
                 f"{args.ctrl_headroom}")

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.core import (ClusterTrace, ClusterTraceConfig, CoalesceConfig,
                            HarvestRuntime, PrefetchConfig,
                            TopologyAwarePolicy, get_topology)
    from repro_torch.models import model as M
    from repro_torch.serving import (ControllerConfig, SpecDecodeConfig,
                               TenantSpec, Workload)
    from repro_torch.serving.engine import check_servable

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    check_servable(cfg)
    params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    budget = int(args.peer_budget_mb * 2**20)
    topology = get_topology(args.topology) if args.topology else None
    budgets = (topology.device_budgets(budget) if topology
               else {0: budget, 1: budget})
    trace = None
    if args.with_churn:
        trace = ClusterTrace(ClusterTraceConfig(
            num_devices=len(budgets), capacity_bytes=2 * budget,
            seed=args.seed, job_arrival_p=0.3, job_size_frac=(0.2, 0.6)))
    coalesce = None
    if args.coalesce or args.stripe:
        coalesce = CoalesceConfig(
            stripe_ways=args.stripe,
            chunk_nbytes=args.stripe_chunk_kb << 10,
            min_stripe_nbytes=int(args.stripe_min_mb * 2**20))
    runtime = HarvestRuntime(
        budgets, trace=trace, topology=topology,
        policy=TopologyAwarePolicy(topology) if topology else None,
        coalesce=coalesce,
        monitor_interval_s=(args.monitor_interval_us * 1e-6
                            if args.monitor_interval_us else None))

    mode = "async" if (args.prefetch or coalesce is not None
                       or args.chunk_prefill_tokens is not None) else args.mode
    spec = (SpecDecodeConfig(draft_tokens=args.spec_draft,
                             accept_rate=args.spec_accept_rate)
            if args.spec_draft else None)
    controller = None
    if args.controller == "stability":
        ctrl_kwargs = {}
        if args.ctrl_tick_us is not None:
            ctrl_kwargs["tick_interval_s"] = args.ctrl_tick_us * 1e-6
        if args.ctrl_headroom is not None:
            ctrl_kwargs["headroom"] = args.ctrl_headroom
        controller = ControllerConfig(**ctrl_kwargs)
    server = runtime.server(
        cfg, params, max_batch=args.max_batch, block_size=args.block_size,
        num_local_slots=args.local_slots,
        scheduler=args.scheduler, durability=args.durability, seed=args.seed,
        mode=mode, prefetch=PrefetchConfig() if args.prefetch else None,
        admission=args.admission, prefix_cache=args.prefix_cache,
        chunk_prefill_tokens=args.chunk_prefill_tokens, spec_decode=spec,
        fidelity_policy=args.fidelity_policy, cold_tier=args.cold_tier,
        controller=controller, device=device)
    eng = server.engine

    if args.workload == "legacy":
        # compat wrapper: every request visible at clock 0, one class
        rng = np.random.default_rng(args.seed)
        reqs = []
        for _ in range(args.num_requests):
            n = int(rng.integers(5, 40))
            reqs.append(eng.submit(
                list(rng.integers(3, min(cfg.vocab_size, 250), size=n)),
                args.max_new_tokens))
        stats = eng.run()
    else:
        tenants = []
        for part in args.tenants.split(","):
            klass, _, weight = part.partition(":")
            klass = klass.strip()
            slo_s = args.slo_ms * 1e-3 if args.slo_ms else None
            tenants.append(TenantSpec(
                klass, weight=float(weight or 1), slo=klass,
                priority=1 if klass == "latency" else 0,
                prompt_len=(5, 20) if klass == "latency" else (5, 40),
                max_new_tokens=args.max_new_tokens,
                ttft_slo_s=slo_s if klass == "latency" else None,
                e2e_slo_s=slo_s * 10 if (slo_s and klass == "latency")
                else None,
                prefix_share=args.prefix_share,
                prefix_len=args.prefix_len))
        workload = Workload(
            num_requests=args.num_requests, arrival=args.workload,
            rate=args.arrival_rate, seed=args.seed, tenants=tuple(tenants),
            vocab=(3, min(cfg.vocab_size, 250)))
        stats = server.run(workload)
        reqs = [h._req for h in server.handles]
    served = [r for r in eng.finished if r.state == "done"]
    print(f"\n{len(served)}/{len(reqs)} requests served "
          f"({stats.rejected} shed by admission)")
    print(stats.summary())
    print(f"kv manager: {dict(eng.kv_mgr.stats)}")
    print(f"allocator:  {dict(eng.allocator.stats)}")
    print(f"tiers:      {runtime.tier_counts()}")
    for r in served[:4]:
        print(f"  req {r.req_id} [{r.slo}] t={r.arrival_t * 1e3:.3f}ms: "
              f"{len(r.prompt)} prompt -> {r.output[:8]}…")


if __name__ == "__main__":
    main()
