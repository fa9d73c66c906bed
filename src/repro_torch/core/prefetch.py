"""Cross-step prefetcher — speculative reloads issued under compute windows.

The serving engine's decode step has a compute window (weight-read bound,
:mod:`repro_torch.core.simulator`'s observation) during which the peer and host
links would otherwise sit idle.  The :class:`Prefetcher` fills that window:

  * **KV blocks** (paper §5): ``KVOffloadManager.plan_prefetch`` names the
    non-local blocks the next steps will read — the append-boundary blocks
    of running requests plus the resident prefix of preempted requests
    about to be re-admitted.  The prefetcher reloads them peer→local (or
    host→local) on the event-driven transfer timeline so they are ready
    before the step that reads them, instead of stalling that step.
  * **Expert weights** (paper §4): via ``ExpertRebalancer.plan_promotions``
    the prefetcher promotes the hottest host-resident experts into peer
    HBM, so the next expert miss is served over the fast link.

Two budgets bound speculation:

  * **free local slots** — a prefetch only ever fills a *free* slot, and
    the slot floor (``min_free_slots`` raised per window by the engine's
    worst-case next allocations) guarantees it is never the reason a
    later allocation evicts.  Placement decisions therefore never change,
    which keeps decoded tokens bit-identical to the sync engine under
    ``host_backed`` durability.  (Under ``lossy`` durability with
    revocation churn, a prefetched block has simply left the peer tier
    *before* a revocation could drop it — prefetch can only reduce
    recomputes, never add them, but rescuing a block that the sync run
    lost legitimately changes that run's tokens.)
  * **link budget** — a prefetch (or hot-expert promotion) is skipped when
    its lane's queue is already projected busy past the current compute
    window (``window_slack`` scales the window), so speculative traffic
    never delays the demand fetches queued ahead of it.

Every issued transfer is tracked until the engine either *claims* the
block (a later step reads it — a **hit**) or the block is evicted / its
request freed before any read (a **waste**).  The counters land in the
shared :class:`~repro_torch.core.store.MetricsRegistry` under ``prefetch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.store import (MetricsRegistry, ObjectKey, Tier, Transfer,
                              TransferEngine, channel_name)


@dataclass
class PrefetchConfig:
    """Knobs for the cross-step prefetcher.

    ``prefetch_depth`` is how many future append-boundary blocks per
    running request are eligible; ``resume_lookahead`` how many
    head-of-line preempted waiters get their prefix warmed;
    ``min_free_slots`` the local-slot floor prefetch must never consume;
    ``max_inflight`` the cap on outstanding speculative transfers;
    ``window_slack`` the fraction of the compute window a lane may be
    filled to; ``expert_migrations`` the number of hot host-resident
    experts promoted per window (0 disables the rebalancer hook).
    """
    prefetch_depth: int = 1
    resume_lookahead: int = 2
    min_free_slots: int = 2
    max_inflight: int = 8
    window_slack: float = 1.0
    expert_migrations: int = 0


class Prefetcher:
    STAT_KEYS = ("issued", "hits", "wasted", "skipped_slots",
                 "skipped_budget", "expert_promotions")

    def __init__(self, kv, transfers: TransferEngine,
                 config: Optional[PrefetchConfig] = None, *,
                 rebalancer=None, planner=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.kv = kv
        self.te = transfers
        self.cfg = config or PrefetchConfig()
        self.rebalancer = rebalancer
        #: optional :class:`~repro_torch.core.coalesce.TransferPlanner`: a
        #: window's prefetches then land as coalesced batches (link budgets
        #: charge one setup per lane per window, not one per block)
        self.planner = planner
        self.stats = (metrics or transfers.metrics).counters(
            "prefetch", keys=self.STAT_KEYS)
        #: runtime budget throttle in (0, 1] — the stability controller
        #: lowers it when peer revocations spike so speculative traffic
        #: stops competing with demand reloads; 1.0 is bit-exact with
        #: the un-throttled prefetcher
        self.throttle = 1.0
        #: block -> its in-flight speculative reload (claimed or wasted later)
        self.inflight: Dict[ObjectKey, Transfer] = {}

    # ------------------------------------------------------------- issue
    def run(self, window_s: float, running=(), waiting=(),
            slot_floor: Optional[int] = None) -> List[Transfer]:
        """Issue speculative transfers for one compute window.

        ``running``/``waiting`` are the engine's request lists.
        ``slot_floor`` raises ``min_free_slots`` for this window — the
        engine passes its worst-case next allocations (append blocks +
        head-of-line prefill) so a prefetch can never be the reason a
        later allocation evicts.  Returns the KV transfers issued this
        window (already submitted on the timeline) so the caller can
        account their seconds; expert promotions ride the timeline too but
        are background moves, accounted only by the transfer metrics.
        """
        issued: List[Transfer] = []
        pending: List[Transfer] = []      # planner path: batch-submitted
        lane_load: Dict[str, float] = {}  # this window's projected lane use
        floor = max(self.cfg.min_free_slots, slot_floor or 0)
        run_pairs = [(r.req_id, r.pos) for r in running]
        wait_ids = [r.req_id for r in waiting
                    if not r.needs_prefill][:self.cfg.resume_lookahead]
        budget_end = (self.te.now
                      + window_s * self.cfg.window_slack * self.throttle)
        max_inflight = max(int(self.cfg.max_inflight * self.throttle), 1)
        for bid in self.kv.plan_prefetch(run_pairs, wait_ids,
                                         depth=self.cfg.prefetch_depth):
            if bid in self.inflight:
                continue
            if len(self.inflight) >= max_inflight:
                break
            if len(self.kv.free_slots) <= floor:
                self.stats["skipped_slots"] += 1
                break
            ent = self.kv.table[bid]
            # link budgets are per *device* lane: a prefetch from peer 3
            # only has to fit in peer3_in's window, regardless of how busy
            # the other peers' lanes are
            dev = ent.handle.device if ent.handle is not None else None
            ch = self.te.lane_for(ent.tier, Tier.LOCAL_HBM, dev)
            if self.planner is not None:
                # coalesced budget: the window's first transfer on a lane
                # opens the batch (full setup + bytes); the rest only add
                # their bytes time — budgets count batches, not members
                est = self.planner.projected_lane_s(
                    ent.nbytes, ent.tier, Tier.LOCAL_HBM, dev,
                    first_on_lane=ch not in lane_load)
            else:
                est = self.te.estimate(ent.nbytes, ent.tier,
                                       Tier.LOCAL_HBM, dev)
            if (self.te.channel_busy_until(ch) + lane_load.get(ch, 0.0)
                    + est > budget_end):
                self.stats["skipped_budget"] += 1
                continue
            # free slots guaranteed above, so this never evicts
            ops = self.kv.ensure_resident(*bid)
            if self.planner is not None:
                pending.extend(ops)
                lane_load[ch] = lane_load.get(ch, 0.0) + est
            else:
                for op in ops:
                    self.te.submit(op)
            if ops:
                self.inflight[bid] = ops[-1]
                self.stats["issued"] += 1
                issued.extend(ops)
        if pending:
            self.planner.submit(pending)
        self._promote_experts(budget_end)
        return issued

    def _promote_experts(self, budget_end: float) -> None:
        """Hot-expert promotion (rebalancer hook): host->peer moves on the
        timeline, bounded by the same link budget as KV prefetch."""
        if self.rebalancer is None or not self.cfg.expert_migrations:
            return
        store = self.rebalancer.store
        ch = channel_name(Tier.HOST_DRAM, Tier.PEER_HBM)
        done = 0
        lane_load = 0.0
        pending: List[Transfer] = []
        for eid in self.rebalancer.plan_promotions(
                self.cfg.expert_migrations * 4):
            if done >= self.cfg.expert_migrations:
                break
            if self.planner is not None:
                est = self.planner.projected_lane_s(
                    store.table[eid].nbytes, Tier.HOST_DRAM, Tier.PEER_HBM,
                    first_on_lane=not pending)
            else:
                est = self.te.estimate(store.table[eid].nbytes,
                                       Tier.HOST_DRAM, Tier.PEER_HBM)
            if self.te.channel_busy_until(ch) + lane_load + est > budget_end:
                self.stats["skipped_budget"] += 1
                break
            op = store.promote_to_peer(eid)
            if not op:
                break
            ops = op if isinstance(op, list) else [op]
            if self.planner is not None:
                pending.extend(ops)
                lane_load += est
            else:
                for o in ops:
                    self.te.submit(o)
            done += 1
        if pending:
            self.planner.submit(pending)
        self.stats["expert_promotions"] += done

    # ----------------------------------------------------------- outcome
    def claim(self, bid: ObjectKey) -> Optional[Transfer]:
        """A step is about to read ``bid``: if it was prefetched, count the
        hit and hand the transfer back so the step can wait on it."""
        tr = self.inflight.pop(bid, None)
        if tr is not None:
            self.stats["hits"] += 1
        return tr

    def on_evict(self, bid: ObjectKey) -> None:
        """The block left local HBM before any read — the prefetch was
        wasted (and its slot churned for nothing)."""
        if self.inflight.pop(bid, None) is not None:
            self.stats["wasted"] += 1

    def cancel_owner(self, owner) -> None:
        """The owner's blocks were freed (request finished or its prefix is
        being recomputed) — unclaimed prefetches are waste."""
        for bid in [b for b in self.inflight
                    if isinstance(b, tuple) and b[0] == owner]:
            del self.inflight[bid]
            self.stats["wasted"] += 1
