"""HarvestRuntime — the facade composing allocator + monitor + policy + store.

Every entry point (serving engine, pipeline simulator, launchers,
benchmarks, examples) constructs ONE of these instead of hand-wiring the
four components.  The runtime owns:

  * the :class:`HarvestAllocator` (peer budgets + placement policy),
  * the :class:`TransferEngine` (all simulated transfer accounting),
  * the :class:`MetricsRegistry` (one namespaced counter store for the
    allocator, every client store, and the transfer engine),
  * optionally a :class:`PeerMonitor` driving revocations from a cluster
    trace,
  * a registry of per-client :class:`HarvestStore` instances.

Clients are factories on the runtime: ``runtime.kv_manager(...)`` and
``runtime.rebalancer(...)`` return the paper's two applications already
wired into the shared allocator / transfer engine / metrics; new object
classes (SSM states, prefix caches, LoRA adapters) use
``runtime.create_store(...)`` directly and get the same residency ladder,
revocation handling and accounting for free.

    runtime = HarvestRuntime(device_budgets={0: 8 << 30, 1: 8 << 30},
                             hardware=H100_NVLINK,
                             trace_config=ClusterTraceConfig(num_devices=2))
    kv = runtime.kv_manager(cfg, block_size=16, num_local_slots=64)
    reb = runtime.rebalancer(cfg, local_fraction=0.5)
    runtime.tick()                      # external pressure -> revocations
    print(runtime.stats())              # unified metrics snapshot
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import HarvestAllocator
from repro_torch.core.coalesce import CoalesceConfig, TransferPlanner
from repro_torch.core.kv_manager import KVOffloadManager
from repro_torch.core.monitor import ClusterTrace, ClusterTraceConfig, PeerMonitor
from repro_torch.core.policy import PlacementPolicy
from repro_torch.core.rebalancer import ExpertRebalancer
from repro_torch.core.store import HarvestStore, MetricsRegistry, TransferEngine
from repro_torch.core.tiers import H100_NVLINK, HardwareModel, Topology


class HarvestRuntime:
    def __init__(self, device_budgets: Optional[Dict[int, int]] = None, *,
                 hardware: Optional[HardwareModel] = None,
                 topology: Optional[Topology] = None,
                 policy: Optional[PlacementPolicy] = None,
                 allocator: Optional[HarvestAllocator] = None,
                 trace: Optional[ClusterTrace] = None,
                 trace_config: Optional[ClusterTraceConfig] = None,
                 monitor: Optional[PeerMonitor] = None,
                 reserve_bytes: int = 0,
                 monitor_interval_s: Optional[float] = None,
                 coalesce: Optional[CoalesceConfig] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics or MetricsRegistry()
        if hardware is None:
            hardware = topology.hardware if topology else H100_NVLINK
        self.hardware = hardware
        self.topology = topology
        self.allocator = allocator or HarvestAllocator(
            dict(device_budgets or {}), policy=policy, metrics=self.metrics)
        self.transfers = TransferEngine(hardware, self.metrics,
                                        topology=topology)
        #: transfer coalescing/striping layer (None = per-object compat
        #: path): attached to every client store this runtime creates
        self.planner: Optional[TransferPlanner] = (
            TransferPlanner(self.transfers, coalesce, metrics=self.metrics)
            if coalesce is not None else None)
        if monitor is None and (trace is not None or trace_config is not None):
            trace = trace or ClusterTrace(trace_config)
            monitor = PeerMonitor(self.allocator, trace,
                                  capacity_bytes=trace.cfg.capacity_bytes,
                                  reserve_bytes=reserve_bytes,
                                  tick_interval_s=monitor_interval_s,
                                  metrics=self.metrics,
                                  devices=(list(topology.devices)
                                           if topology else None))
        self.monitor = monitor
        self.stores: Dict[str, HarvestStore] = {}
        self.clients: Dict[str, object] = {}

    # ----------------------------------------------------------- factories
    def create_store(self, client: str, **kwargs) -> HarvestStore:
        """A tiered store for a NEW object class — the extension seam."""
        store = HarvestStore(self.allocator, self.transfers, client=client,
                             metrics=self.metrics, **kwargs)
        store.planner = self.planner
        self.stores[client] = store
        return store

    def kv_manager(self, cfg: ModelConfig, *, block_size: int,
                   num_local_slots: int, durability: str = "host_backed",
                   store_payload: bool = False, num_kv_layers: int = 0,
                   client: str = "kv", ssd_tier: bool = False,
                   host_capacity_bytes: Optional[int] = None
                   ) -> KVOffloadManager:
        """The paper's §5 application: paged KV cache entries."""
        mgr = KVOffloadManager(
            cfg, self.allocator, self.hardware, block_size, num_local_slots,
            durability=durability, store_payload=store_payload,
            num_kv_layers=num_kv_layers, client=client,
            transfers=self.transfers, metrics=self.metrics,
            ssd_tier=ssd_tier, host_capacity_bytes=host_capacity_bytes)
        mgr.store.planner = self.planner
        self.stores[client] = mgr.store
        self.clients[client] = mgr
        return mgr

    def rebalancer(self, cfg: ModelConfig, *, local_fraction: float = 0.5,
                   ewma: float = 0.8, client: str = "moe"
                   ) -> ExpertRebalancer:
        """The paper's §4 application: MoE expert weights."""
        reb = ExpertRebalancer(
            cfg, self.allocator, self.hardware, local_fraction=local_fraction,
            ewma=ewma, client=client, transfers=self.transfers,
            metrics=self.metrics)
        reb.store.planner = self.planner
        self.stores[client] = reb.store
        self.clients[client] = reb
        return reb

    def server(self, cfg: ModelConfig, params, **kwargs):
        """The request-lifecycle serving front door
        (:class:`~repro_torch.serving.server.HarvestServer`) over this
        runtime: SLO-classed requests arriving on the transfer-engine
        clock, pluggable admission, per-request latency records.  Engine
        kwargs (``scheduler``, ``mode``, ``prefetch``, ``admission``,
        pool geometry, …) pass through."""
        from repro_torch.serving.server import HarvestServer
        return HarvestServer(cfg, params, runtime=self, **kwargs)

    def prefetcher(self, kv_client: str = "kv",
                   moe_client: Optional[str] = None,
                   config=None):
        """A cross-step :class:`~repro_torch.core.prefetch.Prefetcher` over this
        runtime's transfer timeline, wired to an existing KV client (and
        optionally the expert rebalancer for hot-expert promotion)."""
        from repro_torch.core.prefetch import Prefetcher
        kv = self.clients[kv_client]
        reb = self.clients.get(moe_client) if moe_client else None
        return Prefetcher(kv, self.transfers, config, rebalancer=reb,
                          planner=self.planner, metrics=self.metrics)

    # ------------------------------------------------------------- control
    @property
    def clock(self) -> float:
        """The simulated time of this runtime's transfer timeline."""
        return self.transfers.now

    def drain(self, until: Optional[float] = None):
        """Complete in-flight transfers up to ``until`` (default: now)."""
        return self.transfers.drain_until(
            self.transfers.now if until is None else until)

    def tick(self, steps: int = 1) -> Optional[Dict[int, int]]:
        """Advance the availability monitor (external pressure -> budget
        updates -> revocations).  No-op without a monitor."""
        budgets = None
        if self.monitor is not None:
            for _ in range(steps):
                budgets = self.monitor.tick()
        return budgets

    def poll_pressure(self) -> int:
        """Timeline-driven pressure: let the monitor fire one trace tick
        per configured interval of simulated transfer-clock time.  Called
        by async-mode hosts at stage boundaries so revocations land
        mid-pipeline.  Returns the number of ticks fired."""
        if self.monitor is None:
            return 0
        return self.monitor.poll(self.transfers.now)

    # ------------------------------------------------------------- queries
    def stats(self) -> Dict[str, dict]:
        """One snapshot of every component's counters.  The ``device``
        namespace is the allocator's live per-device view (occupancy,
        budget, churn EWMA) flattened to ``dev{d}.{field}`` keys so it
        rides the same reporting pipeline as the counters."""
        out = self.metrics.snapshot()
        out.setdefault("allocator", dict(self.allocator.stats))
        # live per-store fidelity census: demoted copies currently resident
        # at a reduced precision (FP16-resident blocks are the baseline and
        # stay out of the snapshot so fidelity-off runs are unchanged)
        fid_blocks = {
            f"{name}.blocks_{f}": n
            for name, store in sorted(self.stores.items())
            for f, n in sorted(store.fidelity_counts().items())
            if n and f != "fp16"}
        if fid_blocks:
            out.setdefault("fid", {}).update(fid_blocks)
        out["device"] = {
            f"dev{d}.{k}": v
            for d, view in sorted(self.allocator.device_view().items())
            for k, v in sorted(view.items())}
        return out

    def tier_counts(self) -> Dict[str, Dict[str, int]]:
        return {name: store.tier_counts()
                for name, store in self.stores.items()}
