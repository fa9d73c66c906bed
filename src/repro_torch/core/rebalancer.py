"""Expert Rebalancer — the MoE-weights client of :class:`HarvestStore` (§4).

At server start a user-defined subset of experts is resident in local HBM;
the rest live in host DRAM (authoritative copy, always kept — expert weights
are the BACKED durability class).  As peer memory becomes available the
rebalancer migrates the *hottest* non-local experts into peer HBM via the
store's promote primitive; on revocation the store falls the entry back to
host and future fetches take the slow path again.  Routing, batching and the
FFN math are untouched (the paper's "no model code changes" property) —
residency only changes *where a miss is served from*.

Hotness-ranked migration is a policy loop over the generic store, not a
parallel residency implementation: the store owns the table, revocation
wiring and transfer accounting.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import HarvestAllocator
from repro_torch.core.store import (Durability, HarvestStore, MetricsRegistry,
                              ObjectEntry, Residency, TransferEngine)
from repro_torch.core.tiers import HardwareModel, Tier, expert_bytes

ExpertId = Tuple[int, int]   # (moe_layer_index, expert_index)

MOE_STAT_KEYS = ("peer_hits", "host_hits", "local_hits", "migrations",
                 "revocations")

_HIT_STAT = {
    Residency.LOCAL: "local_hits",
    Residency.PEER: "peer_hits",
    Residency.HOST: "host_hits",
}


class ExpertRebalancer:
    def __init__(self, cfg: ModelConfig, allocator: HarvestAllocator,
                 hardware: HardwareModel, local_fraction: float = 0.5,
                 ewma: float = 0.8, client: str = "moe",
                 transfers: Optional[TransferEngine] = None,
                 metrics: Optional[MetricsRegistry] = None):
        assert cfg.moe is not None
        self.cfg = cfg
        self.allocator = allocator
        self.hw = hardware
        self.ewma = ewma
        self.client = client
        self.expert_nbytes = expert_bytes(cfg)
        # expert weights: no managed local slot pool (the local set is pinned
        # at startup), BACKED durability (host copy is always authoritative)
        self.store = HarvestStore(
            allocator, transfers or TransferEngine(hardware, metrics),
            client=client, object_nbytes=self.expert_nbytes,
            num_local_slots=None, durability=Durability.BACKED,
            stat_keys=MOE_STAT_KEYS)

        n_local = int(cfg.moe.num_experts * local_fraction)
        for li in range(cfg.num_moe_layers):
            for e in range(cfg.moe.num_experts):
                local = e < n_local
                self.store.register(
                    (li, e),
                    state=Residency.LOCAL if local else Residency.HOST,
                    pinned=local)

    # ------------------------------------------------------- store views
    @property
    def stats(self) -> Dict[str, int]:
        return self.store.stats

    @property
    def residency(self) -> Dict[ExpertId, ObjectEntry]:
        return self.store.table

    # ------------------------------------------------------------- access
    def record_access(self, layer: int, experts: np.ndarray) -> None:
        """EWMA-update hotness from this step's routing decisions."""
        counts = np.bincount(np.asarray(experts).reshape(-1),
                             minlength=self.cfg.moe.num_experts)
        for e, c in enumerate(counts):
            self.store.touch_hotness((layer, e), float(c), self.ewma)

    def fetch(self, layer: int, expert: int) -> Tuple[Tier, float]:
        """Resolve one expert fetch; returns (tier served from, seconds)."""
        ent = self.store.table[(layer, expert)]
        self.stats[_HIT_STAT[ent.state]] += 1
        op = self.store.transfers.transfer(
            (layer, expert), self.expert_nbytes, ent.tier, Tier.LOCAL_HBM,
            client=self.client, device=self.device_of(layer, expert))
        return ent.tier, op.seconds

    # --------------------------------------------------------- rebalance
    def plan_promotions(self, limit: int) -> list:
        """Hottest host-resident experts, best promotion candidates first.

        This is the rebalancer's prefetch hook: the
        :class:`~repro_torch.core.prefetch.Prefetcher` consumes the plan during
        compute windows the same way ``rebalance`` does eagerly.
        """
        return [eid for eid, _ent in
                self.store.hottest(Residency.HOST, limit=limit)]

    def rebalance(self, max_migrations: int = 16) -> int:
        """Migrate hottest host-resident experts into available peer HBM."""
        done = 0
        for eid in self.plan_promotions(max_migrations * 4):
            if done >= max_migrations:
                break
            if not self.store.promote_to_peer(eid):
                break
            done += 1
        return done

    def demote(self, layer: int, expert: int) -> None:
        """Voluntarily release a peer-resident expert (policy-driven)."""
        self.store.demote((layer, expert))

    # ------------------------------------------------------------ queries
    def tier_of(self, layer: int, expert: int) -> Tier:
        return self.store.table[(layer, expert)].tier

    def device_of(self, layer: int, expert: int):
        """Peer device a PEER-resident expert lives on (else None)."""
        return self.store.device_of((layer, expert))

    def residency_fractions(self) -> Dict[str, float]:
        counts = self.store.tier_counts()
        n = max(len(self.store.table), 1)
        return {k: v / n for k, v in counts.items()}
