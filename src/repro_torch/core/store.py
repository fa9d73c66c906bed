"""HarvestStore — the generic tiered-object layer every Harvest client shares.

The paper's two applications — expert weights (§4) and KV cache entries
(§5) — are both "objects with a durability class placed across
{local, peer, host} tiers".  This module is the single implementation of
that shape:

  * :class:`HarvestStore` owns the residency table
    (``ObjectKey -> ObjectEntry``), the peer-then-host eviction ladder,
    revocation handling for both durability classes, and the
    promote / demote / pin primitives.  Clients (the KV block table, the
    expert rebalancer, or any future object class — SSM states, prefix
    caches, LoRA adapters) register objects and policy hooks instead of
    re-implementing residency bookkeeping.
  * :class:`Durability` is the application's contract with revocation:
    ``BACKED`` objects have (or get, on eviction) an authoritative host
    copy and fall back to host transparently; ``RECONSTRUCTIBLE`` objects
    are peer-only and transition to the explicit ``LOST`` residency state,
    so a dropped object can never be confused with a freshly allocated one.
  * :class:`TransferEngine` centralises all simulated transfer-time
    accounting (previously scattered across ``ReloadOp.seconds``,
    ``ExpertRebalancer.fetch`` and the engine's ``_apply_ops``) and owns
    the event-driven transfer timeline: a simulated clock plus one FIFO
    queue per directional link lane.  Lanes are *per peer device*: with an
    interconnect :class:`~repro_torch.core.tiers.Topology` attached, a transfer
    that names peer device ``d`` rides ``peer{d}_in``/``peer{d}_out`` and
    is charged that device's :class:`~repro_torch.core.tiers.LinkSpec`, so
    transfers to distinct peers pipeline in parallel while each pair
    serialises FIFO.  Device 1 keeps the legacy ``peer_in``/``peer_out``
    lane names (the 2-device compat mapping); ``host_in``/``host_out``
    stay single-laned — there is one PCIe path to DRAM.  The legacy
    batched ``schedule`` reduction remains as the sync-mode compat
    wrapper.
  * :class:`MetricsRegistry` is the unified, namespaced counter store that
    replaces the per-component ad-hoc ``stats`` dicts.

All times are seconds, sizes bytes.
"""
from __future__ import annotations

import collections
import enum
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.allocator import HarvestAllocator, HarvestHandle
from repro_torch.core.tiers import Fidelity, HardwareModel, Tier, Topology

ObjectKey = Hashable


class Durability(enum.Enum):
    """What revocation is allowed to cost the application (paper §3.2)."""
    BACKED = "backed"                    # host copy authoritative; revocation
                                         # falls back to host transparently
    RECONSTRUCTIBLE = "reconstructible"  # peer-only; revocation loses the
                                         # payload and the client recomputes


class Residency(enum.Enum):
    """Where an object currently lives.  LOST is an explicit terminal state
    for revoked RECONSTRUCTIBLE objects — not a sentinel encoded in other
    fields."""
    LOCAL = "local"
    PEER = "peer"
    HOST = "host"
    SSD = "ssd"
    LOST = "lost"


_RESIDENCY_TIER = {
    Residency.LOCAL: Tier.LOCAL_HBM,
    Residency.PEER: Tier.PEER_HBM,
    Residency.HOST: Tier.HOST_DRAM,
    Residency.SSD: Tier.LOCAL_SSD,
}
_TIER_RESIDENCY = {v: k for k, v in _RESIDENCY_TIER.items()}


class LostObjectError(RuntimeError):
    """Raised when a client touches an object whose payload was revoked."""


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class Counters(dict):
    """A dict of counters: reading a missing key yields 0, so ``c[k] += v``
    needs no setdefault dance and pre-seeded keys keep stable print order."""

    def __missing__(self, key):
        return 0


class MetricsRegistry:
    """Namespaced counters shared by every component of one runtime.

    ``counters("kv")`` always returns the same live dict, so a client's
    ``stats`` attribute and the registry's snapshot view the same numbers.
    """

    def __init__(self):
        self._namespaces: Dict[str, Counters] = {}

    def counters(self, namespace: str, keys: Iterable[str] = ()) -> Counters:
        ns = self._namespaces.setdefault(namespace, Counters())
        for k in keys:
            ns.setdefault(k, 0)
        return ns

    def namespaces(self) -> List[str]:
        return list(self._namespaces)

    def snapshot(self) -> Dict[str, dict]:
        return {name: dict(ns) for name, ns in self._namespaces.items()}


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class Transfer:
    """One simulated tier-to-tier move.

    A freshly minted transfer is *pending*: it carries a size and a raw
    link time (``seconds``) but no position on the timeline.  Sync clients
    sum pending transfers with :meth:`TransferEngine.schedule`; async
    clients :meth:`TransferEngine.submit` them onto the per-link FIFO
    queues, which stamps ``issue_t``/``ready_t``, and later complete them
    with :meth:`TransferEngine.drain_until`.
    """
    key: ObjectKey
    src: Tier
    dst: Tier
    nbytes: int
    seconds: float
    client: str = "default"
    device: Optional[int] = None   # peer device the payload lives on/moves to
    # --- coalescing / striping fields (set by the TransferPlanner) ---
    parent: Optional[ObjectKey] = None  # object key a stripe chunk belongs to
    offset: int = 0          # chunk's byte offset within its parent object
    lane: Optional[str] = None   # forced lane (stripe sub-lanes); None = route
    batch_id: int = 0        # coalesced-batch membership (0 = solo submission)
    #: precision of the payload ON THE WIRE — ``nbytes`` is already the
    #: fidelity-scaled wire size; the planner refuses to coalesce or stripe
    #: transfers of mixed fidelity into one batch (one gather kernel call
    #: packs one dtype)
    fidelity: Fidelity = Fidelity.FP16
    # --- timeline fields (live only once submitted) ---
    issue_t: float = 0.0     # simulated time the transfer was enqueued
    ready_t: float = 0.0     # simulated time the payload is usable at dst
    lane_s: float = 0.0      # lane occupancy actually charged (== seconds
                             # solo; less the saved setup inside a batch)
    channel: str = ""        # directional link lane the transfer occupies
    done: bool = True        # un-submitted transfers count as complete

    @property
    def dep_key(self) -> ObjectKey:
        """Key same-object ordering chains on: the parent for stripe chunks
        (siblings must NOT serialise on each other — see
        :meth:`TransferEngine.submit_chunks`), else the object key."""
        return self.key if self.parent is None else self.parent


def _link_name(src: Tier, dst: Tier) -> str:
    pair = {src, dst}
    if pair == {Tier.LOCAL_HBM}:
        return "hbm"
    if Tier.LOCAL_SSD in pair:
        return "ssd"
    if Tier.HOST_DRAM in pair:
        return "host"
    return "peer"


#: the peer device whose lanes keep the legacy un-numbered names — the
#: 2-device presets put their single peer at device 1, so pre-topology
#: metrics keys (``q.peer_in.*``) and goldens stay stable
LEGACY_PEER_DEVICE = 1


class _LaneKeys:
    """Pre-interned per-lane metrics keys (one instance per lane, built on
    first submission) — the hot submit/drain paths index counters through
    these instead of re-formatting ``f"q.{ch}.*"`` strings per event."""
    __slots__ = ("submitted", "first_issue_t", "busy_s", "last_ready_t",
                 "depth", "peak", "completed")

    def __init__(self, ch: str):
        self.submitted = f"q.{ch}.submitted"
        self.first_issue_t = f"q.{ch}.first_issue_t"
        self.busy_s = f"q.{ch}.busy_s"
        self.last_ready_t = f"q.{ch}.last_ready_t"
        self.depth = f"q.{ch}.depth"
        self.peak = f"q.{ch}.peak"
        self.completed = f"q.{ch}.completed"


def channel_name(src: Tier, dst: Tier, device: Optional[int] = None,
                 host: int = 0) -> str:
    """Directional lane of a physical link, per peer device.

    NVLink / ICI / PCIe are full duplex: writes out of local HBM
    (evictions) and reads into local HBM (reloads) move on opposite
    directions of the same link and do not contend with each other.  Each
    direction serialises its own FIFO queue.  Peer links are additionally
    *per device*: transfers touching peer device ``d`` ride
    ``peer{d}_in``/``peer{d}_out`` so distinct peers never queue behind
    each other; device :data:`LEGACY_PEER_DEVICE` (and transfers naming no
    device) keep the legacy ``peer_in``/``peer_out`` names.  The host path
    is one physical PCIe link regardless of which peer is involved.

    A nonzero ``host`` places the peer device on a REMOTE host: the
    transfer rides that host's shared ``dcn{h}_in``/``dcn{h}_out`` lane
    pair instead of a per-device lane — there is one DCN NIC pair per host
    pair, so a remote host's devices contend for it while distinct remote
    hosts still pipeline in parallel.
    """
    base = _link_name(src, dst)
    if base == "hbm":
        return base
    if base == "peer":
        if host:
            base = f"dcn{host}"
        elif device is not None and device != LEGACY_PEER_DEVICE:
            base = f"peer{device}"
    return f"{base}_in" if dst is Tier.LOCAL_HBM else f"{base}_out"


class TransferEngine:
    """Single source of truth for simulated transfer times.

    Every tier move in the system is minted here, so per-link byte/time
    accounting lands in one metrics namespace instead of three stats dicts.

    The engine also owns the *simulated transfer timeline*: a clock
    (``now``) plus one FIFO queue per directional link lane.  ``submit``
    enqueues a minted transfer (stamping ``issue_t``/``ready_t`` from the
    lane's busy-until time and any in-flight transfer of the same key) and
    ``drain_until`` advances the clock, completing everything whose
    ``ready_t`` has passed.  The legacy :meth:`schedule` — a pure
    pre-summed-seconds reduction — is kept as the sync-mode compat wrapper
    and is what the seed-equivalence goldens exercise.
    """

    def __init__(self, hardware: HardwareModel,
                 metrics: Optional[MetricsRegistry] = None,
                 topology: Optional[Topology] = None):
        self.hw = topology.hardware if (hardware is None and topology) \
            else hardware
        self.topology = topology
        self.metrics = metrics or MetricsRegistry()
        self._stats = self.metrics.counters("transfer")
        self.now: float = 0.0
        self._channel_busy: Dict[str, float] = {}
        self._inflight: Dict[str, "collections.deque[Transfer]"] = {}
        self._key_busy: Dict[ObjectKey, Transfer] = {}
        self._batch_seq: int = 0
        # hot-path caches: routed LinkSpec per (src, dst, device) and
        # pre-interned metrics keys per lane / per (client, link) — the
        # per-event f-string formatting showed up hot in the 1M-request
        # sweeps (the keys are invariant per lane, only the counts change)
        self._spec_cache: Dict[Tuple, "object"] = {}
        self._lane_keys: Dict[str, _LaneKeys] = {}
        self._client_keys: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
        # opt-in submit log (benchmarks reconstruct exact per-lane busy
        # intervals from it; off by default — it grows without bound)
        self.record_log: bool = False
        self.log: List[Transfer] = []

    def lane_of(self, t: Transfer) -> str:
        """The directional lane a pending transfer will occupy: its forced
        ``lane`` (stripe sub-lanes) or the routed one.  The single routing
        rule shared by submission, coalescing and reload-plan grouping."""
        return t.lane or self.lane_for(t.src, t.dst, t.device)

    def lane_for(self, src: Tier, dst: Tier,
                 device: Optional[int] = None) -> str:
        """The directional lane a (src, dst, device) transfer occupies.

        Per-device peer lanes exist only when an interconnect topology is
        attached AND the device is one of its peers: a flat
        :class:`HardwareModel` declares ONE peer link, so every peer
        transfer keeps the legacy single lane pair no matter how callers
        number their devices.  A peer device the topology places on a
        remote host routes to that host's shared ``dcn{h}`` lane pair.
        """
        host = 0
        if self.topology is None or device not in self.topology.peer_links:
            device = None
        elif self.topology.device_hosts:
            host = self.topology.host_of(device)
        return channel_name(src, dst, device, host)

    def link_spec(self, src: Tier, dst: Tier,
                  device: Optional[int] = None):
        """The :class:`~repro_torch.core.tiers.LinkSpec` a (src, dst, device)
        transfer is charged against — the coalescing/striping layer reads
        its setup ``latency`` and link-disjoint ``paths`` from here.
        Routed specs are cached per (src, dst, device): the topology is
        immutable, and the repeated ``link()`` dict walks (plus the fresh
        hbm LinkSpec it constructs) showed up hot in the sweep loops."""
        ck = (src, dst, device)
        spec = self._spec_cache.get(ck)
        if spec is None:
            spec = (self.topology.link(src, dst, device)
                    if self.topology is not None
                    else self.hw.link(src, dst))
            self._spec_cache[ck] = spec
        return spec

    def estimate(self, nbytes: int, src: Tier, dst: Tier,
                 device: Optional[int] = None,
                 fidelity: Optional[Fidelity] = None) -> float:
        """Link time of a hypothetical transfer (no accounting) — the
        topology's per-device link when one is attached and named.
        ``fidelity`` scales ``nbytes`` (a full-precision object size) down
        to the wire size that precision actually moves."""
        if fidelity is not None:
            nbytes = fidelity.wire_bytes(nbytes)
        return self.link_spec(src, dst, device).transfer_time(nbytes)

    def transfer(self, key: ObjectKey, nbytes: int, src: Tier, dst: Tier,
                 extra_latency: float = 0.0, client: str = "default",
                 device: Optional[int] = None,
                 fidelity: Optional[Fidelity] = None) -> Transfer:
        """Mint a pending transfer of a full-precision-size-``nbytes``
        object.  A quantized ``fidelity`` moves (and accounts) only the
        wire bytes of that precision; FP16 (the default) is byte-exact
        with the seed accounting."""
        fid = fidelity or Fidelity.FP16
        wire = fid.wire_bytes(nbytes)
        seconds = self.estimate(wire, src, dst, device) + extra_latency
        link = _link_name(src, dst)
        ks = self._client_keys.get((client, link))
        if ks is None:
            ks = (f"{client}.{link}_s", f"{client}.{link}_n",
                  f"{client}.{link}_bytes")
            self._client_keys[(client, link)] = ks
        self._stats[ks[0]] += seconds
        self._stats[ks[1]] += 1
        self._stats[ks[2]] += wire
        return Transfer(key, src, dst, wire, seconds, client=client,
                        device=device, fidelity=fid)

    def schedule(self, transfers: Iterable[Transfer],
                 overlap_links: bool = False) -> float:
        """Total wall time for a batch of transfers (sync compat path).

        Default is serial issue (one DMA queue — matches the engine's
        original accounting).  With ``overlap_links`` the batch is grouped
        by physical link (peer ICI/NVLink vs host PCIe): each link
        serialises its own transfers, distinct links run concurrently.
        The event-driven path (:meth:`submit` + :meth:`drain_until`)
        supersedes this for async clients.
        """
        if not overlap_links:
            return float(sum(t.seconds for t in transfers))
        per_link: Dict[str, float] = {}
        for t in transfers:
            link = _link_name(t.src, t.dst)
            per_link[link] = per_link.get(link, 0.0) + t.seconds
        return max(per_link.values(), default=0.0)

    def overlap(self, compute_s: float, transfer_s: float,
                enabled: bool = True) -> float:
        """CGOPipe-style overlap: transfers hide under compute when enabled."""
        return max(compute_s, transfer_s) if enabled else compute_s + transfer_s

    # ------------------------------------------------------------- timeline
    def _enqueue(self, t: Transfer, ch: str, lane_s: float,
                 start: float) -> Transfer:
        """Place a pending transfer on lane ``ch`` occupying ``lane_s``
        seconds from ``start``.  Shared by the solo, coalesced and striped
        submission paths; per-lane FIFO order is preserved because every
        caller derives ``start`` from the lane's busy-until time."""
        t.channel = ch
        t.issue_t = self.now
        t.lane_s = lane_s
        t.ready_t = start + lane_s
        t.done = False
        self._channel_busy[ch] = t.ready_t
        self._key_busy[t.dep_key] = t
        q = self._inflight.setdefault(ch, collections.deque())
        q.append(t)
        if self.record_log:
            self.log.append(t)
        ks = self._lane_keys.get(ch)
        if ks is None:
            ks = self._lane_keys[ch] = _LaneKeys(ch)
        stats = self._stats
        if not stats[ks.submitted]:
            stats[ks.first_issue_t] = t.issue_t
        stats[ks.submitted] += 1
        stats[ks.busy_s] += lane_s
        stats[ks.last_ready_t] = t.ready_t
        stats[ks.depth] = len(q)
        if len(q) > stats[ks.peak]:
            stats[ks.peak] = len(q)
        return t

    def submit(self, t: Transfer, not_before: float = 0.0) -> Transfer:
        """Enqueue a pending transfer on its directional link lane.

        The transfer starts once the lane is free AND any in-flight
        transfer of the same key has completed (a reload of a block whose
        eviction write-back is still on the wire must wait for it), and
        becomes ready ``seconds`` later.  Per-lane FIFO order is preserved
        by construction: ``ready_t`` is non-decreasing within a lane.

        ``not_before`` floors the start time at a future production event
        the payload waits on that is NOT itself a transfer — e.g. a
        disaggregated prefill chunk finishing on its pool worker before
        its KV blocks can enter the DCN stream.
        """
        ch = self.lane_of(t)
        start = max(self.now, not_before, self._channel_busy.get(ch, 0.0))
        dep = self._key_busy.get(t.dep_key)
        if dep is not None and not dep.done:
            start = max(start, dep.ready_t)
        return self._enqueue(t, ch, t.seconds, start)

    def submit_coalesced(self, members: Iterable[Transfer],
                         not_before: float = 0.0) -> List[Transfer]:
        """Submit same-lane transfers as ONE batched lane occupancy.

        The batch pays the lane's per-transfer setup latency once (the
        simulated analogue of a single multi-slot ``harvest_gather`` call):
        member 0 keeps its full ``seconds``; every later member occupies
        only its bytes time.  Completion still resolves per member —
        ``ready_t`` is stamped at each member's cumulative byte boundary,
        so a waiter on one object never waits for the whole batch's tail.

        ``not_before`` floors the batch start at a production event that
        is not itself a transfer (a disaggregated prefill chunk finishing
        on another host), exactly like :meth:`submit`'s floor.

        Members that route to a different lane, carry a different wire
        fidelity (one batched submission models one fused gather kernel
        call, and one kernel packs one dtype), or whose object has an
        unresolved in-flight transfer (same-key ordering), fall back to
        the solo :meth:`submit` path — a dependency must not stall the
        batch.
        """
        members = list(members)
        if not members:
            return []
        out: List[Transfer] = []
        ch = self.lane_of(members[0])
        fid = members[0].fidelity
        batched: List[Transfer] = []
        solo: List[Transfer] = []
        for t in members:
            lane_t = self.lane_of(t)
            dep = self._key_busy.get(t.dep_key)
            if (lane_t != ch or t.fidelity is not fid
                    or (dep is not None and not dep.done)):
                solo.append(t)
            else:
                batched.append(t)
        # the batch goes FIRST: a dependency-blocked member would otherwise
        # head-of-line-block the lane's FIFO while it waits for its dep
        if len(batched) >= 2:
            setup = self.link_spec(batched[0].src, batched[0].dst,
                                   batched[0].device).latency
            self._batch_seq += 1
            start = max(self.now, not_before,
                        self._channel_busy.get(ch, 0.0))
            saved = 0.0
            for i, t in enumerate(batched):
                lane_s = t.seconds if i == 0 else max(t.seconds - setup, 0.0)
                saved += t.seconds - lane_s
                t.batch_id = self._batch_seq
                self._enqueue(t, ch, lane_s, start)
                start = t.ready_t
                out.append(t)
            self._stats[f"q.{ch}.coalesced"] += 1
            self._stats[f"q.{ch}.coalesced_members"] += len(batched)
            self._stats[f"q.{ch}.coalesced_saved_s"] += saved
        else:
            solo = batched + solo
        for t in solo:
            out.append(self.submit(t, not_before=not_before))
        return out

    def split(self, t: Transfer, ways: int, chunk_nbytes: int
              ) -> List[Transfer]:
        """Re-mint one pending transfer as chunk transfers striped across
        ``ways`` link-disjoint sub-lanes (``<lane>.s<k>``), each sustaining
        the link's per-path bandwidth.  The last chunk may be short — a
        non-divisible object size pads nothing and loses nothing.  The
        per-client link metrics are re-stated from the whole object to its
        chunks (bytes conserved; the chunk count replaces the single
        transfer count)."""
        link = self.link_spec(t.src, t.dst, t.device)
        ways = max(1, min(ways, link.paths))
        chunk_nbytes = max(1, chunk_nbytes)   # a 0-byte chunk never advances
        if ways <= 1 or t.nbytes <= chunk_nbytes:
            return [t]
        base = t.lane or self.lane_for(t.src, t.dst, t.device)
        path_bw = link.path_bandwidth
        extra = max(0.0, t.seconds - link.transfer_time(t.nbytes))
        chunks: List[Transfer] = []
        off = 0
        i = 0
        while off < t.nbytes:
            nb = min(chunk_nbytes, t.nbytes - off)
            chunks.append(Transfer(
                key=("~chunk", t.key, i), src=t.src, dst=t.dst, nbytes=nb,
                seconds=link.latency + nb / path_bw + (extra if i == 0 else 0),
                client=t.client, device=t.device, parent=t.key, offset=off,
                lane=f"{base}.s{i % ways}"))
            off += nb
            i += 1
        link_name = _link_name(t.src, t.dst)
        self._stats[f"{t.client}.{link_name}_s"] += \
            sum(c.seconds for c in chunks) - t.seconds
        self._stats[f"{t.client}.{link_name}_n"] += len(chunks) - 1
        self._stats[f"q.{base}.stripe_objects"] += 1
        self._stats[f"q.{base}.stripe_chunks"] += len(chunks)
        self._stats[f"q.{base}.stripe_ways"] = max(
            ways, self._stats[f"q.{base}.stripe_ways"])
        return chunks

    def submit_chunks(self, chunks: Iterable[Transfer]) -> List[Transfer]:
        """Striped submission: the chunks of ONE object ride their assigned
        sub-lanes concurrently, coalesced per sub-lane (one setup each).

        An in-flight transfer of the parent key (the object's eviction
        write-back) delays every chunk; afterwards the parent key maps to
        the LAST-finishing chunk, so a future same-key transfer chains on
        stripe completion, never on a partial prefix.
        """
        chunks = list(chunks)
        if not chunks:
            return []
        pkey = chunks[0].parent
        dep = self._key_busy.get(pkey)
        floor = dep.ready_t if (dep is not None and not dep.done) else self.now
        per_lane: Dict[str, List[Transfer]] = {}
        for t in chunks:
            per_lane.setdefault(t.lane, []).append(t)
        self._batch_seq += 1
        last: Optional[Transfer] = None
        for ch, members in per_lane.items():
            setup = self.link_spec(members[0].src, members[0].dst,
                                   members[0].device).latency
            start = max(floor, self.now, self._channel_busy.get(ch, 0.0))
            for i, t in enumerate(members):
                lane_s = t.seconds if i == 0 else max(t.seconds - setup, 0.0)
                t.batch_id = self._batch_seq
                self._enqueue(t, ch, lane_s, start)
                start = t.ready_t
                if last is None or t.ready_t > last.ready_t:
                    last = t
        self._key_busy[pkey] = last
        return chunks

    def drain_until(self, t: float) -> List[Transfer]:
        """Advance the clock to ``t`` (never backwards) and complete every
        in-flight transfer whose ``ready_t`` has passed.  Returns the
        completed transfers."""
        if t > self.now:
            self.now = t
        done: List[Transfer] = []
        key_busy, stats = self._key_busy, self._stats
        for ch, q in self._inflight.items():
            if not q or q[0].ready_t > self.now:
                continue
            ks = self._lane_keys[ch]
            while q and q[0].ready_t <= self.now:
                tr = q.popleft()
                tr.done = True
                if key_busy.get(tr.dep_key) is tr:
                    del key_busy[tr.dep_key]
                stats[ks.completed] += 1
                done.append(tr)
            stats[ks.depth] = len(q)
        return done

    def advance(self, seconds: float) -> List[Transfer]:
        """Let simulated time pass (a compute window) and drain."""
        return self.drain_until(self.now + seconds)

    def wait_for(self, transfers: Iterable[Transfer],
                 prefix_nbytes: Optional[int] = None) -> float:
        """Block the clock until every given transfer has completed;
        returns the new ``now``.  Already-complete transfers are free.

        ``prefix_nbytes`` is the chunk-granular completion contract of a
        striped reload: only the stripe chunks covering byte range
        ``[0, prefix_nbytes)`` of their parent object are waited on, so a
        consumer that needs an object's prefix resumes as soon as that
        prefix has landed.  Non-chunk transfers are always waited on.
        """
        target = self.now
        for t in transfers:
            if t.done:
                continue
            if (prefix_nbytes is not None and t.parent is not None
                    and t.offset >= prefix_nbytes):
                continue
            target = max(target, t.ready_t)
        if target > self.now:
            self.drain_until(target)
        return self.now

    def retarget(self, old: ObjectKey, new: ObjectKey) -> None:
        """Re-key the same-object ordering chain: a future transfer of
        ``new`` chains behind any in-flight transfer submitted under
        ``old`` (used by :meth:`HarvestStore.rekey` — a block published
        into the prefix trie keeps its in-flight write-back ordering)."""
        t = self._key_busy.pop(old, None)
        if t is None:
            return
        if t.parent is not None:
            t.parent = new
        else:
            t.key = new
        self._key_busy[new] = t

    def inflight_for(self, key: ObjectKey) -> Optional[Transfer]:
        """The in-flight transfer currently moving ``key`` (None when the
        object is quiescent).  A step that needs a block another path
        already submitted (a prefetch, an earlier resume) attaches to this
        transfer instead of double-submitting."""
        t = self._key_busy.get(key)
        return t if (t is not None and not t.done) else None

    def pending(self, channel: Optional[str] = None) -> int:
        """Number of in-flight transfers (optionally on one lane)."""
        if channel is not None:
            return len(self._inflight.get(channel, ()))
        return sum(len(q) for q in self._inflight.values())

    def channel_busy_until(self, channel: str) -> float:
        """Simulated time the lane's queue runs dry (>= ``now``)."""
        return max(self.now, self._channel_busy.get(channel, 0.0))

    def queue_depths(self) -> Dict[str, int]:
        return {ch: len(q) for ch, q in self._inflight.items() if q}


# ---------------------------------------------------------------------------
# residency table
# ---------------------------------------------------------------------------

_MISSING = object()   # rekey's "key absent from LRU" sentinel


@dataclass
class ObjectEntry:
    """One object's placement.  Clients may subclass to carry domain fields
    (the KV block table adds ``base_pos``/``filled``)."""
    state: Residency = Residency.HOST
    durability: Durability = Durability.BACKED
    local_slot: Optional[int] = None
    handle: Optional[HarvestHandle] = None   # live only while state is PEER
    host_copy: bool = False                  # an authoritative host copy exists
    hotness: float = 0.0                     # EWMA of client-defined heat
    pinned: bool = False                     # never evicted from local
    nbytes: int = 0                          # FULL-precision payload size
    #: precision of the DEMOTED copy (peer/host/SSD parking + wire format).
    #: The local slot always holds full precision: quantize-on-demote sets
    #: this, dequantize-on-reload clears it back to FP16.
    fidelity: Fidelity = Fidelity.FP16
    #: extra holders beyond the base owner (prefix-cache leases).  While
    #: positive, :meth:`HarvestStore.release` drops one reference instead
    #: of freeing — a retiring request can never free a block the trie (or
    #: another lessee) still reads.
    refcount: int = 0

    @property
    def tier(self) -> Optional[Tier]:
        return _RESIDENCY_TIER.get(self.state)


class HarvestStore:
    """Residency table + tier ladder for one client's object class.

    A store is parameterised by the client name (metrics namespace and
    allocator fairness tag), the default object size, an optional local
    slot pool (``num_local_slots=None`` means the local tier is unmanaged —
    e.g. pinned expert weights), and the default durability class.
    """

    #: every counter the store itself may bump — clients pre-seed a subset
    EVENTS = ("allocated", "freed", "evict_to_peer", "evict_to_host",
              "evict_to_ssd", "reload_peer", "reload_host", "reload_ssd",
              "revocations", "recomputes", "migrations", "demotions")

    #: pre-seeded ``fid.*`` counters (the fidelity-policy metrics contract)
    FID_KEYS = ("bytes_saved", "demote_quantized", "reload_dequantized",
                "quant_s", "dequant_s")

    def __init__(self, allocator: HarvestAllocator, transfers: TransferEngine,
                 *, client: str = "default", object_nbytes: int = 0,
                 num_local_slots: Optional[int] = None,
                 durability: Durability = Durability.BACKED,
                 store_payload: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 owner_fn: Optional[Callable[[ObjectKey], Hashable]] = None,
                 entry_factory: Callable[..., ObjectEntry] = ObjectEntry,
                 stat_keys: Iterable[str] = (),
                 ssd_tier: bool = False,
                 host_capacity_bytes: Optional[int] = None):
        self.allocator = allocator
        self.transfers = transfers
        self.client = client
        self.object_nbytes = object_nbytes
        self.durability = durability
        self.entry_factory = entry_factory
        #: cold tier below host: RECONSTRUCTIBLE evictions that find no
        #: peer room park on local NVMe instead of paying for host DRAM,
        #: and BACKED write-backs overflow to it once ``host_capacity_bytes``
        #: is exhausted.  Off by default — the seed ladder is unchanged.
        self.ssd_tier = ssd_tier
        self.host_capacity_bytes = host_capacity_bytes
        # owners group keys for pinning / bulk eviction / bulk release; the
        # default matches (request_id, block_idx)-style composite keys
        self.owner_fn = owner_fn or (
            lambda k: k[0] if isinstance(k, tuple) else k)
        self.stats = (metrics or transfers.metrics).counters(
            client, keys=stat_keys)

        self.table: Dict[ObjectKey, ObjectEntry] = {}
        self.lru: "collections.OrderedDict[ObjectKey, None]" = \
            collections.OrderedDict()
        self.num_local_slots = num_local_slots
        self.free_slots: List[int] = (
            list(range(num_local_slots)) if num_local_slots is not None else [])
        self.pinned_owners: Set = set()

        self.store_payload = store_payload
        self._payload: Dict[ObjectKey, np.ndarray] = {}
        #: optional :class:`~repro_torch.core.coalesce.TransferPlanner` — when
        #: attached (HarvestRuntime built with a CoalesceConfig), the
        #: placement methods emit *plans*: large objects leave as chunk
        #: transfers striped over link-disjoint sub-lanes, and callers hand
        #: whole step plans back to the planner for same-lane batching.
        #: None (default) keeps the seed-exact loose-transfer path.
        self.planner = None
        # policy hooks: called with (key, local_slot) so the embedding layer
        # (e.g. the serving engine's pool arrays) can move real payloads
        # alongside the placement
        self.evict_hook: Optional[Callable[[ObjectKey, int], None]] = None
        self.reload_hook: Optional[Callable[[ObjectKey, int], None]] = None
        #: fidelity policy hook: maps an object key to the
        #: :class:`~repro_torch.core.tiers.Fidelity` its demoted copy travels at.
        #: None (default) keeps every demotion at FP16 — the seed-exact
        #: path.  Set by the serving engine from its per-SLO
        #: :class:`~repro_torch.core.policy.FidelityPolicy`.
        self.fidelity_fn: Optional[Callable[[ObjectKey], Fidelity]] = None
        self.fid_stats = (metrics or transfers.metrics).counters(
            "fid", keys=self.FID_KEYS)

    def _prepare(self, ops: List[Transfer]) -> List[Transfer]:
        """Planner pass over freshly minted transfers (striping); identity
        when no planner is attached — the compat path."""
        return ops if self.planner is None else self.planner.prepare(ops)

    # ------------------------------------------------------------ lifecycle
    def register(self, key: ObjectKey, *, state: Residency = Residency.HOST,
                 durability: Optional[Durability] = None,
                 nbytes: Optional[int] = None, pinned: bool = False,
                 **extra) -> ObjectEntry:
        """Track an object that already exists in some tier (no transfer)."""
        assert key not in self.table, f"object {key} already registered"
        durability = durability or self.durability
        ent = self.entry_factory(
            state=state, durability=durability,
            nbytes=self.object_nbytes if nbytes is None else nbytes,
            pinned=pinned,
            host_copy=(durability is Durability.BACKED
                       or state is Residency.HOST),
            **extra)
        self.table[key] = ent
        return ent

    def allocate_local(self, key: ObjectKey, *, nbytes: Optional[int] = None,
                       **extra) -> Tuple[int, List[Transfer]]:
        """Place a NEW object in a local slot, evicting LRU if needed."""
        assert key not in self.table, f"object {key} already allocated"
        assert self.num_local_slots is not None, \
            f"{self.client}: store has no managed local pool"
        ops: List[Transfer] = []
        if not self.free_slots:
            ops.extend(self._evict_one(exclude_owner=self.owner_fn(key)))
        slot = self.free_slots.pop()
        self.table[key] = self.entry_factory(
            state=Residency.LOCAL, durability=self.durability,
            nbytes=self.object_nbytes if nbytes is None else nbytes,
            local_slot=slot, **extra)
        self.lru[key] = None
        self.stats["allocated"] += 1
        return slot, self._prepare(ops)

    def incref(self, key: ObjectKey) -> int:
        """Add one shared reference (a prefix-cache lease).  Each
        :meth:`release` drops one reference before any actual free."""
        ent = self.table[key]
        ent.refcount += 1
        return ent.refcount

    def release(self, key: ObjectKey) -> bool:
        """Drop one reference; free the object only when none remain.

        Unshared objects (``refcount == 0``, the default) free
        immediately — the legacy semantics.  Shared objects decrement and
        stay tracked, so a retiring owner can never free a block the
        prefix trie or another lessee still references.  Returns True iff
        the object was actually freed."""
        ent = self.table[key]
        if ent.refcount > 0:
            ent.refcount -= 1
            self.stats["ref_drops"] += 1
            return False
        self.table.pop(key)
        if ent.state is Residency.LOCAL and self.num_local_slots is not None:
            self.free_slots.append(ent.local_slot)
        elif ent.state is Residency.PEER and ent.handle is not None:
            self.allocator.harvest_free(ent.handle)
        self.lru.pop(key, None)
        self._payload.pop(key, None)
        self.stats["freed"] += 1
        return True

    def release_owner(self, owner) -> None:
        for key in [k for k in self.table if self.owner_fn(k) == owner]:
            self.release(key)

    def rekey(self, old: ObjectKey, new: ObjectKey) -> ObjectEntry:
        """Transfer an entry to a new key in place: slot, handle, payload,
        LRU recency and any in-flight transfer follow the object.  This is
        how a retiring request's prompt block becomes a content-addressed
        prefix-cache block without moving a byte."""
        assert new not in self.table, f"rekey target {new} already tracked"
        ent = self.table.pop(old)
        self.table[new] = ent
        if self.lru.pop(old, _MISSING) is not _MISSING:
            self.lru[new] = None
        if old in self._payload:
            self._payload[new] = self._payload.pop(old)
        if ent.state is Residency.PEER and ent.handle is not None:
            # re-register the revocation callback under the new key — the
            # old closure would no-op against a key no longer in the table
            self.allocator.harvest_register_cb(
                ent.handle,
                lambda handle, key=new: self._on_revoked(key, handle.device))
        self.transfers.retarget(old, new)
        return ent

    # ------------------------------------------------------------- eviction
    def _evict_one(self, exclude_owner=None,
                   victim: Optional[ObjectKey] = None,
                   exclude_key: Optional[ObjectKey] = None) -> List[Transfer]:
        """Evict one local object down the ladder: peer first, host fallback.

        Victims from other owners are preferred; when only the excluded
        owner's objects remain local (single-request long-context), its LRU
        object other than ``exclude_key`` is evicted instead.
        """
        if victim is None:
            fallback = None
            for key in self.lru:
                ent = self.table[key]
                if (ent.state is not Residency.LOCAL or ent.pinned
                        or self.owner_fn(key) in self.pinned_owners):
                    continue
                if exclude_owner is None or self.owner_fn(key) != exclude_owner:
                    victim = key
                    break
                if fallback is None and key != exclude_key:
                    fallback = key
            if victim is None:
                victim = fallback
        if victim is None:
            raise RuntimeError(
                f"{self.client}: local pool exhausted — no evictable object")
        ent = self.table[victim]
        # the fidelity the demoted copy travels at is decided BEFORE the
        # evict hook fires: the embedding layer (the serving engine's
        # quantize-on-demote path) reads ``ent.fidelity`` to pick the
        # kernel that packs the payload out of the pool
        fid = Fidelity.FP16
        if self.fidelity_fn is not None:
            fid = self.fidelity_fn(victim) or Fidelity.FP16
        ent.fidelity = fid
        quant_s = 0.0
        if fid.is_quantized:
            # fused quantize_demote: one full-precision read pass over the
            # block through local HBM, charged on the same clock as the
            # eviction transfer it feeds
            quant_s = ent.nbytes / self.transfers.hw.hbm_bw
            self.fid_stats["demote_quantized"] += 1
            self.fid_stats["quant_s"] += quant_s
            self.fid_stats["bytes_saved"] += \
                ent.nbytes - fid.wire_bytes(ent.nbytes)
            self.fid_stats[f"demote_{fid.value}"] += 1
        if self.evict_hook is not None:
            self.evict_hook(victim, ent.local_slot)
        if self.num_local_slots is not None:
            self.free_slots.append(ent.local_slot)
        ent.local_slot = None
        self.lru.pop(victim, None)

        ops: List[Transfer] = []
        wire = fid.wire_bytes(ent.nbytes)
        # hints: "refs" marks shared prefix-cache blocks (hot trie
        # interiors) — placement policies steer them to stable peers,
        # because revoking a block many future requests would hit costs
        # more than revoking a private one.  A quantized block asks the
        # allocator for its WIRE size — half (int8/fp8) or a quarter
        # (int4) of the peer slot a full-precision block would take.
        h = self.allocator.harvest_alloc(
            wire, hints={"hot": ent.hotness, "refs": ent.refcount},
            client=self.client)
        if h is not None:
            ent.state = Residency.PEER
            ent.handle = h
            self.allocator.harvest_register_cb(
                h, lambda handle, key=victim: self._on_revoked(
                    key, handle.device))
            ops.append(self.transfers.transfer(
                victim, ent.nbytes, Tier.LOCAL_HBM, Tier.PEER_HBM,
                extra_latency=quant_s, client=self.client, device=h.device,
                fidelity=fid))
            self.stats["evict_to_peer"] += 1
            self.stats[f"dev{h.device}.evictions"] += 1
            if ent.durability is Durability.BACKED:
                ent.host_copy = True   # written back asynchronously
        elif self._ssd_rung(ent, wire):
            # cold tier: RECONSTRUCTIBLE objects get a durable option
            # cheaper than host DRAM (and strictly better than LOST);
            # BACKED write-backs land here once host capacity is spent
            ent.state = Residency.SSD
            ent.host_copy = False      # the SSD copy is the backing copy
            ops.append(self.transfers.transfer(
                victim, ent.nbytes, Tier.LOCAL_HBM, Tier.LOCAL_SSD,
                extra_latency=quant_s, client=self.client, fidelity=fid))
            self.stats["evict_to_ssd"] += 1
        else:
            ent.state = Residency.HOST
            ent.host_copy = True       # the host write IS the eviction
            ops.append(self.transfers.transfer(
                victim, ent.nbytes, Tier.LOCAL_HBM, Tier.HOST_DRAM,
                extra_latency=quant_s, client=self.client, fidelity=fid))
            self.stats["evict_to_host"] += 1
        return ops

    def _ssd_rung(self, ent: ObjectEntry, wire: int) -> bool:
        """Whether a peer-less eviction takes the SSD rung instead of host:
        RECONSTRUCTIBLE objects always do (they otherwise pay host DRAM
        for payloads the class declared droppable), BACKED objects only
        once the host budget is spent."""
        if not self.ssd_tier:
            return False
        if ent.durability is Durability.RECONSTRUCTIBLE:
            return True
        return (self.host_capacity_bytes is not None
                and self._host_wire_bytes() + wire > self.host_capacity_bytes)

    def _host_wire_bytes(self) -> int:
        """Wire bytes currently parked in HOST residency (the overflow
        meter for ``host_capacity_bytes``; async BACKED peer copies are
        not counted — they are shadows, not placements)."""
        return sum(e.fidelity.wire_bytes(e.nbytes)
                   for e in self.table.values()
                   if e.state is Residency.HOST)

    def evict_owner(self, owner) -> List[Transfer]:
        """Preemption support (paper §6.3): push ALL of an owner's local
        objects out to the peer/host tiers."""
        ops: List[Transfer] = []
        self.pinned_owners.discard(owner)
        for key in sorted(k for k in self.table if self.owner_fn(k) == owner):
            if self.table[key].state is Residency.LOCAL:
                ops.extend(self._evict_one(victim=key))
        return self._prepare(ops)

    # --------------------------------------------------------------- reload
    def ensure_local(self, key: ObjectKey) -> List[Transfer]:
        """Fetch-mode reload: make an object local (LRU-touch it either way)."""
        ent = self.table[key]
        self.lru.pop(key, None)
        self.lru[key] = None     # touch
        if ent.state is Residency.LOCAL:
            return []
        if ent.state is Residency.LOST:
            raise LostObjectError(
                f"{self.client}: object {key} was revoked without a host "
                "copy — the client must reconstruct it")
        ops: List[Transfer] = []
        slot = None
        if self.num_local_slots is not None:
            if not self.free_slots:
                ops.extend(self._evict_one(
                    exclude_owner=self.owner_fn(key), exclude_key=key))
            slot = self.free_slots.pop()
        src = ent.tier
        device = None
        if ent.state is Residency.PEER:
            self.stats["reload_peer"] += 1
            if ent.handle is not None:
                device = ent.handle.device
                self.stats[f"dev{device}.reloads"] += 1
                self.allocator.harvest_free(ent.handle)
                ent.handle = None
        elif ent.state is Residency.SSD:
            self.stats["reload_ssd"] += 1
        else:
            self.stats["reload_host"] += 1
        fid = ent.fidelity
        dequant_s = 0.0
        if fid.is_quantized:
            # fused dequantize_reload: one full-precision write pass back
            # into the local pool, charged on the reload's critical path
            dequant_s = ent.nbytes / self.transfers.hw.hbm_bw
            self.fid_stats["reload_dequantized"] += 1
            self.fid_stats["dequant_s"] += dequant_s
        ent.state = Residency.LOCAL
        ent.local_slot = slot
        if self.reload_hook is not None:
            # the hook runs while ``ent.fidelity`` still names the wire
            # precision — the embedding layer picks its dequantize kernel
            # from it
            self.reload_hook(key, slot)
        ops.append(self.transfers.transfer(
            key, ent.nbytes, src, Tier.LOCAL_HBM, extra_latency=dequant_s,
            client=self.client, device=device, fidelity=fid))
        ent.fidelity = Fidelity.FP16   # the local slot holds full precision
        return self._prepare(ops)

    # ------------------------------------------------------ promote / demote
    def promote_to_peer(self, key: ObjectKey):
        """Migrate a host-resident object into peer HBM (background path —
        the move is not charged to any request's critical path).  Returns
        the pending transfer (truthy) so timeline clients can ``submit``
        it, or None when the object is not promotable.  With a planner
        attached the promotion is emitted as a *plan* — a (possibly
        chunk-striped) transfer list — instead of one loose transfer."""
        ent = self.table[key]
        if ent.state is not Residency.HOST:
            return None
        h = self.allocator.harvest_alloc(
            ent.fidelity.wire_bytes(ent.nbytes),
            hints={"hot": ent.hotness, "refs": ent.refcount},
            client=self.client)
        if h is None:
            return None
        self.allocator.harvest_register_cb(
            h, lambda handle, key=key: self._on_revoked(key, handle.device))
        ent.state = Residency.PEER
        ent.handle = h
        if ent.durability is Durability.RECONSTRUCTIBLE:
            ent.host_copy = False   # the class does not pay for host backing
        op = self.transfers.transfer(key, ent.nbytes, Tier.HOST_DRAM,
                                     Tier.PEER_HBM, client=self.client,
                                     device=h.device, fidelity=ent.fidelity)
        self.stats["migrations"] += 1
        self.stats[f"dev{h.device}.migrations"] += 1
        return op if self.planner is None else self._prepare([op])

    def demote(self, key: ObjectKey) -> None:
        """Voluntarily release a peer-resident object back to host."""
        ent = self.table[key]
        if ent.state is Residency.PEER and ent.handle is not None:
            self.allocator.harvest_free(ent.handle)
            ent.state = Residency.HOST
            ent.handle = None
            ent.host_copy = True    # the demotion write re-materialises it
            self.stats["demotions"] += 1

    def pin(self, key: ObjectKey, pinned: bool = True) -> None:
        self.table[key].pinned = pinned

    # ------------------------------------------------------------ revocation
    def _on_revoked(self, key: ObjectKey,
                    device: Optional[int] = None) -> None:
        ent = self.table.get(key)
        if ent is None or ent.state is not Residency.PEER:
            return
        ent.handle = None
        self.stats["revocations"] += 1
        if device is not None:
            self.stats[f"dev{device}.revocations"] += 1
        if ent.host_copy:
            ent.state = Residency.HOST    # transparent fallback (BACKED)
        else:
            ent.state = Residency.LOST    # explicit loss (RECONSTRUCTIBLE)
            self.stats["recomputes"] += 1
            self._payload.pop(key, None)

    # -------------------------------------------------------------- hotness
    def touch_hotness(self, key: ObjectKey, sample: float,
                      alpha: float) -> None:
        """EWMA-update an object's heat: h <- alpha*h + (1-alpha)*sample."""
        ent = self.table[key]
        ent.hotness = alpha * ent.hotness + (1 - alpha) * sample

    def hottest(self, state: Residency, limit: Optional[int] = None
                ) -> List[Tuple[ObjectKey, ObjectEntry]]:
        cand = [(k, e) for k, e in self.table.items() if e.state is state]
        cand.sort(key=lambda kv: -kv[1].hotness)
        return cand if limit is None else cand[:limit]

    # -------------------------------------------------------------- queries
    def device_of(self, key: ObjectKey) -> Optional[int]:
        """Peer device an object's payload lives on (None unless PEER)."""
        ent = self.table.get(key)
        if ent is None or ent.handle is None:
            return None
        return ent.handle.device

    def is_lost(self, key: ObjectKey) -> bool:
        ent = self.table.get(key)
        return ent is not None and ent.state is Residency.LOST

    def tier_counts(self) -> Dict[str, int]:
        out = {r.value: 0 for r in Residency}
        for ent in self.table.values():
            out[ent.state.value] += 1
        return out

    def fidelity_counts(self) -> Dict[str, int]:
        """Tracked objects per demoted-copy fidelity (LOCAL objects are
        full precision by construction and count under fp16)."""
        out = {f.value: 0 for f in Fidelity}
        for ent in self.table.values():
            out[ent.fidelity.value] += 1
        return out

    def owner_keys(self, owner) -> List[ObjectKey]:
        return sorted(k for k in self.table if self.owner_fn(k) == owner)

    def residency_of(self, owner) -> List[Optional[Tier]]:
        return [self.table[k].tier for k in self.owner_keys(owner)]

    # -------------------------------------------------------------- payloads
    def write_payload(self, key: ObjectKey, data: np.ndarray) -> None:
        if self.store_payload:
            self._payload[key] = np.asarray(data)

    def read_payload(self, key: ObjectKey) -> Optional[np.ndarray]:
        return self._payload.get(key)
