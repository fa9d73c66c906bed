"""Peer-memory availability monitor + synthetic cluster trace.

The paper motivates Harvest with the Alibaba gpu-v2020 trace (Fig 2):
~68% of machines use <=20% of GPU memory and ~87% use <=50%.  We generate a
synthetic trace calibrated to those anchors — each device's external memory
usage is a mean-reverting (OU-like) walk around a base level drawn from a
three-band mixture, with Poisson job arrivals/departures producing the
step changes that trigger Harvest revocations.

The :class:`PeerMonitor` turns a trace into budget updates on the allocator:
harvestable = capacity - external_usage - reserve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.allocator import HarvestAllocator

# Fig 2 anchor points: P(usage <= 0.2) ~= 0.68, P(usage <= 0.5) ~= 0.87.
BANDS = [
    (0.68, 0.02, 0.20),
    (0.19, 0.20, 0.50),
    (0.13, 0.50, 0.95),
]


@dataclass
class ClusterTraceConfig:
    num_devices: int = 8
    capacity_bytes: int = 16 * 2**30
    seed: int = 0
    # temporal dynamics
    mean_revert: float = 0.2       # OU pull toward the base level
    noise: float = 0.008           # fraction-of-capacity per step
    job_arrival_p: float = 0.015   # per device per step
    job_size_frac: Tuple[float, float] = (0.02, 0.12)
    job_lifetime: Tuple[int, int] = (5, 30)
    # volatility scales BOTH the OU noise and the job-arrival rate (the
    # fig8 sweep axis); correlation mixes a cluster-wide common shock into
    # every device's noise — real clusters schedule jobs in waves, so peer
    # budgets move together instead of independently.  Defaults reproduce
    # the legacy trace draw-for-draw.
    volatility: float = 1.0
    correlation: float = 0.0
    # synchronized multi-peer revocation storms: every ``storm_interval``
    # ticks, ALL devices gain ``storm_frac`` of capacity of external
    # usage for ``storm_duration`` ticks — the correlation axis pushed to
    # its limit (a cluster-wide scheduling wave that slams every peer
    # budget at once, the stability controller's adversarial scenario).
    # The schedule is deterministic (consumes NO rng draws), so the
    # default ``None`` keeps seeded legacy traces bit-exact.
    storm_interval: Optional[int] = None
    storm_duration: int = 4
    storm_frac: float = 0.5

    def __post_init__(self):
        if self.storm_interval is not None:
            if self.storm_interval <= 0:
                raise ValueError(f"storm_interval must be positive, got "
                                 f"{self.storm_interval}")
            if not 0 < self.storm_duration <= self.storm_interval:
                raise ValueError(
                    f"storm_duration must be in (0, storm_interval], got "
                    f"{self.storm_duration}")
            if not 0.0 < self.storm_frac <= 1.0:
                raise ValueError(f"storm_frac must be in (0, 1], got "
                                 f"{self.storm_frac}")


class ClusterTrace:
    """Synthetic per-device external memory usage over discrete time."""

    def __init__(self, cfg: ClusterTraceConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        w = np.array([b[0] for b in BANDS])
        band = self.rng.choice(len(BANDS), size=cfg.num_devices, p=w / w.sum())
        lo = np.array([BANDS[b][1] for b in band])
        hi = np.array([BANDS[b][2] for b in band])
        self.base = self.rng.uniform(lo, hi)
        # jobs ride ON TOP of the base level; recentre the base by the
        # expected steady-state job load so the *total* usage marginal stays
        # on the Fig 2 band mixture (arrival_p x mean size x mean lifetime).
        mean_size = 0.5 * (cfg.job_size_frac[0] + cfg.job_size_frac[1])
        mean_life = 0.5 * (cfg.job_lifetime[0] + cfg.job_lifetime[1])
        self._job_load = cfg.job_arrival_p * cfg.volatility \
            * mean_size * mean_life
        self.base = np.clip(self.base - self._job_load, 0.01, 1.0)
        self.level = self.base.copy()
        self.jobs: List[List[tuple]] = [[] for _ in range(cfg.num_devices)]
        self.t = 0

    def step(self) -> np.ndarray:
        """Advance one tick; returns external usage in bytes per device."""
        c = self.cfg
        self.t += 1
        # OU mean reversion + noise (optionally correlated across devices)
        self.level += c.mean_revert * (self.base - self.level)
        sigma = c.noise * c.volatility
        if c.correlation > 0.0:
            rho = min(c.correlation, 1.0)
            common = self.rng.normal(0.0, 1.0)
            idio = self.rng.normal(0.0, 1.0, size=len(self.level))
            self.level += sigma * (rho * common
                                   + np.sqrt(1.0 - rho * rho) * idio)
        else:
            # legacy draw sequence — keeps seeded traces bit-exact
            self.level += self.rng.normal(0, sigma, size=len(self.level))
        # job arrivals / departures (the revocation drivers)
        arrival_p = min(c.job_arrival_p * c.volatility, 1.0)
        for d in range(c.num_devices):
            self.jobs[d] = [(sz, end) for sz, end in self.jobs[d] if end > self.t]
            if self.rng.random() < arrival_p:
                sz = self.rng.uniform(*c.job_size_frac)
                life = self.rng.integers(*c.job_lifetime)
                self.jobs[d].append((sz, self.t + int(life)))
        job_usage = np.array([sum(sz for sz, _ in js) for js in self.jobs])
        usage = np.clip(self.level + job_usage, 0.0, 1.0)
        # synchronized storm window: a deterministic tick schedule (no rng
        # draws — disabled configs stay draw-for-draw legacy-exact)
        if c.storm_interval is not None \
                and self.t % c.storm_interval < c.storm_duration:
            usage = np.clip(usage + c.storm_frac, 0.0, 1.0)
        return (usage * c.capacity_bytes).astype(np.int64)

    def sample_usage_fractions(self, n_machines: int, n_snapshots: int = 100
                               ) -> np.ndarray:
        """Machine-level usage snapshots for the Fig 2 CDF benchmark."""
        rng = np.random.default_rng(self.cfg.seed + 1)
        w = np.array([b[0] for b in BANDS])
        band = rng.choice(len(BANDS), size=(n_snapshots, n_machines), p=w / w.sum())
        lo = np.take([b[1] for b in BANDS], band)
        hi = np.take([b[2] for b in BANDS], band)
        return rng.uniform(lo, hi)


class PeerMonitor:
    """Feeds trace ticks into the allocator as budget updates.

    Two drive modes:

      * **stepwise** (legacy): the host calls :meth:`tick` whenever it
        decides external pressure should advance — e.g. every N scheduler
        iterations, or between benchmark runs.
      * **timeline** (``tick_interval_s`` set): the host calls
        :meth:`poll` with the TransferEngine's simulated ``now`` at stage
        boundaries; the monitor fires one trace tick per elapsed interval.
        Pressure then lands *mid-pipeline* — a revocation can hit while
        the victim device's lanes still carry in-flight transfers, which
        is exactly the failure mode the paper's drain -> invalidate ->
        notify order exists for.
    """

    def __init__(self, allocator: HarvestAllocator, trace: ClusterTrace,
                 capacity_bytes: int, reserve_bytes: int = 0,
                 tick_interval_s: Optional[float] = None, metrics=None,
                 devices: Optional[List[int]] = None):
        self.allocator = allocator
        self.trace = trace
        self.capacity = capacity_bytes
        self.reserve = reserve_bytes
        self.tick_interval_s = tick_interval_s
        # trace row i drives allocator device devices[i]; the default keeps
        # the legacy identity mapping (devices 0..num_devices-1) — topology
        # presets number peers 1..N, so their hosts pass topology.devices
        self.devices = (list(devices) if devices is not None
                        else list(range(trace.cfg.num_devices)))
        if len(self.devices) != trace.cfg.num_devices:
            raise ValueError(
                f"device mapping ({len(self.devices)} devices: "
                f"{self.devices}) does not match the trace width "
                f"({trace.cfg.num_devices}) — a narrower trace would "
                "silently leave peers unpressured")
        self.revocation_log: List[tuple] = []
        self._last_poll: Optional[float] = None
        # duck-typed MetricsRegistry (avoids an import cycle with store)
        self.stats = (metrics.counters("monitor", keys=("ticks",
                                                        "revocations"))
                      if metrics is not None else None)

    def tick(self) -> Dict[int, int]:
        usage = self.trace.step()
        budgets = {}
        for dev, used in zip(self.devices, usage):
            budget = max(int(self.capacity - used - self.reserve), 0)
            revoked = self.allocator.update_budget(dev, budget)
            for h in revoked:
                self.revocation_log.append((self.trace.t, h))
            if self.stats is not None and revoked:
                self.stats["revocations"] += len(revoked)
                self.stats[f"dev{dev}.revocations"] += len(revoked)
            budgets[dev] = budget
        if self.stats is not None:
            self.stats["ticks"] += 1
        return budgets

    def poll(self, now: float) -> int:
        """Timeline drive: fire one tick per ``tick_interval_s`` of
        simulated time elapsed since the previous poll.  Returns the
        number of ticks fired.  No-op unless an interval is configured."""
        if self.tick_interval_s is None:
            return 0
        if self._last_poll is None:
            self._last_poll = now
            return 0
        n = int((now - self._last_poll) / self.tick_interval_s)
        for _ in range(n):
            self.tick()
        self._last_poll += n * self.tick_interval_s
        return n
