"""Transfer coalescing + chunked multi-lane striping (the Fig-3 gap).

The calibrated links in :mod:`repro_torch.core.tiers` charge 34–194 µs of setup
per :class:`~repro_torch.core.store.Transfer`, so small-object traffic — a decode
step's KV-block reloads, a preemption's write-back burst — is dominated by
per-transfer setup when every object is its own submission, exactly the
regime the paper's Fig 3 measures.  A batched block-copy kernel
moves a *batch* of slots in one call; this module is the runtime's
matching transfer-plan layer, sitting between placement decisions (the
:class:`~repro_torch.core.store.HarvestStore` ladder, which stays byte-identical)
and the :class:`~repro_torch.core.store.TransferEngine` timeline:

  * **Coalescing** — transfers issued in one step that ride the same
    directional link lane are submitted as ONE batched lane occupancy
    paying one setup latency plus summed bytes
    (:meth:`TransferEngine.submit_coalesced`).  Batch membership is
    threaded through ``Transfer.batch_id`` and completion still resolves
    per object: each member's ``ready_t`` lands at its cumulative byte
    boundary inside the batch.
  * **Striping** — objects at least ``min_stripe_nbytes`` big (expert
    weights) are split into ``chunk_nbytes`` chunks round-robined across
    up to ``stripe_ways`` of the link's link-disjoint paths
    (``LinkSpec.paths`` — 12 NVLink links, 4 torus ICI paths), each
    sustaining the per-path bandwidth.  Chunk-granular completion means
    ``wait_for(ops, prefix_nbytes=...)`` returns as soon as the needed
    prefix has landed, instead of at the whole object's tail.

The planner is attached by :class:`~repro_torch.core.runtime.HarvestRuntime`
(``coalesce=CoalesceConfig(...)``) and threaded through the serving
engine, prefetcher and pipeline simulator.  With no planner attached every
code path is bit-exact with the per-object seed behaviour — coalescing is
an opt-in overlay, never a silent re-costing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.store import (MetricsRegistry, Transfer, TransferEngine)
from repro_torch.core.tiers import Tier


@dataclass
class CoalesceConfig:
    """Knobs for the transfer coalescing/striping layer.

    ``enabled`` turns same-lane batching on; ``max_batch`` caps members per
    coalesced submission (one DMA descriptor list has finite length);
    ``stripe_ways`` (0/1 = off) is how many link-disjoint paths a large
    object is striped over, bounded by the lane's ``LinkSpec.paths``;
    ``chunk_nbytes`` the stripe chunk size (non-divisible object sizes get
    a short tail chunk); ``min_stripe_nbytes`` the size floor below which
    an object is never striped (chunking a KV block would only add setup).
    """
    enabled: bool = True
    max_batch: int = 16
    stripe_ways: int = 0
    chunk_nbytes: int = 1 << 20
    min_stripe_nbytes: int = 4 << 20

    def __post_init__(self):
        if self.max_batch < 2:
            raise ValueError(f"max_batch={self.max_batch}: a batch needs at "
                             "least 2 members (use enabled=False to turn "
                             "coalescing off)")
        if self.stripe_ways < 0:
            raise ValueError(f"stripe_ways={self.stripe_ways} must be >= 0 "
                             "(0/1 = striping off)")
        if self.chunk_nbytes <= 0 or self.min_stripe_nbytes <= 0:
            raise ValueError(
                f"chunk_nbytes={self.chunk_nbytes} and min_stripe_nbytes="
                f"{self.min_stripe_nbytes} must be positive — a zero-byte "
                "chunk stream never advances")


class TransferPlanner:
    """Turns loose per-object transfers into batched/striped submissions.

    ``prepare`` is the placement-side pass (stripe large objects into
    chunk transfers); ``submit`` is the timeline-side pass (group a step's
    transfers by lane and coalesce each group).  The planner only ever
    re-*schedules* transfers — placement decisions, byte counts and
    per-object completion semantics are untouched, which is what keeps
    decoded tokens bit-identical to per-object submission.
    """

    STAT_KEYS = ("batches", "batch_members", "solo", "saved_setup_s",
                 "striped_objects", "stripe_chunks")

    def __init__(self, engine: TransferEngine,
                 config: Optional[CoalesceConfig] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.te = engine
        self.cfg = config or CoalesceConfig()
        self.stats = (metrics or engine.metrics).counters(
            "coalesce", keys=self.STAT_KEYS)

    # ----------------------------------------------------- placement side
    def prepare(self, ops: List[Transfer]) -> List[Transfer]:
        """Striping pass over freshly minted transfers: objects big enough
        to amortise chunk setup leave as chunk transfers spread over the
        lane's link-disjoint sub-lanes; everything else passes through."""
        out: List[Transfer] = []
        for t in ops:
            out.extend(self._maybe_split(t))
        return out

    def _maybe_split(self, t: Transfer) -> List[Transfer]:
        ways = self.cfg.stripe_ways
        if (ways <= 1 or t.parent is not None
                or t.nbytes < self.cfg.min_stripe_nbytes):
            return [t]
        chunks = self.te.split(t, ways, self.cfg.chunk_nbytes)
        if len(chunks) > 1:
            self.stats["striped_objects"] += 1
            self.stats["stripe_chunks"] += len(chunks)
        return chunks

    # ------------------------------------------------------ timeline side
    def submit(self, ops: List[Transfer]
               ) -> Tuple[List[Transfer], float]:
        """Submit one step's planned transfers onto the timeline.

        Stripe chunks are grouped per parent object and ride their
        sub-lanes concurrently; plain transfers are grouped per lane and
        coalesced in issue order (``max_batch`` members per batch).
        Returns ``(submitted transfers, effective lane seconds)`` — the
        effective seconds are what the batch actually occupies, i.e. the
        sum of per-object times minus the setup latencies the batching
        saved, which is what callers charge to their accounting.
        """
        submitted: List[Transfer] = []
        by_stripe: Dict = {}
        by_lane: Dict[Tuple[str, "Fidelity"], List[Transfer]] = {}
        lane_order: List[Tuple[str, "Fidelity"]] = []
        for t in ops:
            if t.parent is not None:
                # one stripe = the chunks of ONE original transfer: keyed
                # by direction too, so a write-back and a reload of the
                # same object never merge into one concurrent stripe (the
                # reload's chunks must chain behind the write-back via the
                # parent-key dependency instead).  Chunks inherit their
                # parent's fidelity, so a stripe is fidelity-homogeneous
                # by construction.
                by_stripe.setdefault((t.parent, t.src, t.dst), []).append(t)
                continue
            # batches must be fidelity-homogeneous as well as same-lane:
            # one coalesced submission models ONE fused gather kernel
            # call, and one kernel packs one wire dtype — mixed-precision
            # members split into separate batches instead of merging
            ch = (self.te.lane_of(t), t.fidelity)
            if ch not in by_lane:
                lane_order.append(ch)
            by_lane.setdefault(ch, []).append(t)
        for chunks in by_stripe.values():
            submitted.extend(self.te.submit_chunks(chunks))
        for ch in lane_order:
            members = by_lane[ch]
            if not self.cfg.enabled or len(members) == 1:
                for t in members:
                    submitted.append(self.te.submit(t))
                self.stats["solo"] += len(members)
                continue
            for lo in range(0, len(members), self.cfg.max_batch):
                group = members[lo:lo + self.cfg.max_batch]
                before = sum(t.seconds for t in group)
                done = self.te.submit_coalesced(group)
                submitted.extend(done)
                n_batched = sum(1 for t in done if t.batch_id)
                if n_batched > 1:
                    self.stats["batches"] += 1
                    self.stats["batch_members"] += n_batched
                self.stats["solo"] += len(done) - n_batched
                self.stats["saved_setup_s"] += \
                    before - sum(t.lane_s for t in done)
        effective = sum(t.lane_s for t in submitted)
        return submitted, effective

    # -------------------------------------------------------- projections
    def projected_lane_s(self, nbytes: int, src: Tier, dst: Tier,
                         device: Optional[int] = None,
                         first_on_lane: bool = True) -> float:
        """Lane seconds a candidate transfer would occupy if issued into
        the current window: the full link time when it opens a batch, the
        bytes-only marginal cost when it joins one.  The prefetcher's link
        budgets count coalesced batches through this."""
        est = self.te.estimate(nbytes, src, dst, device)
        if self.cfg.enabled and not first_on_lane:
            est = max(est - self.te.link_spec(src, dst, device).latency, 0.0)
        return est
