"""KVOffloadManager — the paged-KV client of :class:`HarvestStore` (§5).

Extends the vLLM-style paged KV manager with a *unified block table*: every
logical block maps to a residency entry in {local HBM, peer HBM, host DRAM}.
All residency mechanics — the LRU eviction ladder (peer first, host
fallback), revocation fallback, transfer-time accounting — live in the
generic store; this client only adds block-table semantics (per-request
block keys, fill tracking, payload shape) on top.  Durability is an
application choice:

  host_backed — eviction to peer ALSO materialises a host copy; revocation
                falls back to host transparently (paper's durable mode).
  lossy       — peer-only; revocation moves the block to the explicit LOST
                residency state and the request must recompute it (paper's
                reconstructible mode).

The manager tracks both the *placement* (bytes, any scale — used by the
dry-run and the simulator) and optionally the *payload* (real numpy block
arrays — used by the serving engine and tests).

Shared-block residency (:mod:`repro_torch.core.prefix_cache`): a request
may *adopt* a content-addressed trie block instead of allocating its own.
The mapping ``shared[(req, j)] -> content_key`` resolves the request's
logical block id onto the shared entry everywhere the manager touches the
table, the lease table guarantees at most ONE live request maps a shared
block at a time (the decode kernel's ``slot_req`` binds each pool slot to
a single batch row), and a second concurrent consumer gets a
copy-on-write split instead — shared blocks are never mutated and never
aliased into two rows.  ``free_request`` routes every release through the
store's refcount, so retiring can never free a block the trie or another
owner still references.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import HarvestAllocator
from repro_torch.core.store import (Durability, HarvestStore, MetricsRegistry,
                              ObjectEntry, ObjectKey, Residency, Transfer,
                              TransferEngine)
from repro_torch.core.tiers import HardwareModel, Tier, kv_block_bytes

BlockId = Tuple[int, int]    # (request_id, block_index_within_request)

#: back-compat alias — a reload op IS a store transfer
ReloadOp = Transfer

DURABILITY = {
    "host_backed": Durability.BACKED,
    "lossy": Durability.RECONSTRUCTIBLE,
}

KV_STAT_KEYS = ("evict_to_peer", "evict_to_host", "evict_to_ssd",
                "reload_peer", "reload_host", "reload_ssd", "revocations",
                "recomputes", "allocated", "freed", "ref_drops")


@dataclass
class BlockEntry(ObjectEntry):
    """Store entry + the block-table fields the decode path reads/writes."""
    base_pos: int = 0
    filled: int = 0                            # tokens written


@dataclass
class ReloadPlan:
    """One step's batched reload plan for a set of blocks.

    Built by :meth:`KVOffloadManager.plan_reloads`: duplicate keys submit
    once, blocks whose reload is already on the wire contribute the
    in-flight transfer (``attached``) instead of a double submission, and
    a LOST block stops the plan at that point so the caller can recompute
    the prefix — with everything planned before it still charged, exactly
    like the per-block loop it replaces.
    """
    ops: List[Transfer] = field(default_factory=list)      # to charge+submit
    touched: List[BlockId] = field(default_factory=list)   # now-local blocks
    attached: List[Transfer] = field(default_factory=list)  # in-flight waits
    lost: Optional[BlockId] = None          # first LOST block hit (if any)
    deduped: int = 0                        # repeated keys dropped

    def by_lane(self, engine: TransferEngine) -> Dict[str, List[Transfer]]:
        """The plan's transfers keyed by the directional link lane each
        occupies (``TransferEngine.lane_of`` — the same routing rule the
        coalescing layer batches over)."""
        out: Dict[str, List[Transfer]] = {}
        for t in self.ops:
            out.setdefault(engine.lane_of(t), []).append(t)
        return out


class KVOffloadManager:
    def __init__(self, cfg: ModelConfig, allocator: HarvestAllocator,
                 hardware: HardwareModel, block_size: int,
                 num_local_slots: int, durability: str = "host_backed",
                 store_payload: bool = False, num_kv_layers: int = 0,
                 client: str = "kv",
                 transfers: Optional[TransferEngine] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 ssd_tier: bool = False,
                 host_capacity_bytes: Optional[int] = None):
        self.cfg = cfg
        self.allocator = allocator
        self.hw = hardware
        self.block_size = block_size
        self.block_nbytes = kv_block_bytes(cfg, block_size)
        self.durability = durability
        self.client = client
        self.num_local_slots = num_local_slots
        self.n_kv_layers = num_kv_layers
        self.store = HarvestStore(
            allocator, transfers or TransferEngine(hardware, metrics),
            client=client, object_nbytes=self.block_nbytes,
            num_local_slots=num_local_slots,
            durability=DURABILITY[durability], store_payload=store_payload,
            entry_factory=BlockEntry, stat_keys=KV_STAT_KEYS,
            ssd_tier=ssd_tier, host_capacity_bytes=host_capacity_bytes)
        #: shared-block residency: (req, block_idx) -> content key of the
        #: adopted prefix-cache block.  Resolved on every table access.
        self.shared: Dict[BlockId, "ObjectKey"] = {}
        #: content key -> the ONE request currently leasing it (slot_req
        #: maps each pool slot to a single batch row, so concurrent
        #: consumers must COW-split instead of double-leasing)
        self.lessee: Dict["ObjectKey", int] = {}

    # ------------------------------------------------------- store views
    @property
    def stats(self) -> Dict[str, int]:
        return self.store.stats

    @property
    def table(self) -> Dict[BlockId, BlockEntry]:
        return self.store.table

    @property
    def free_slots(self) -> List[int]:
        return self.store.free_slots

    @property
    def pinned(self) -> set:
        """Requests whose blocks must not be evicted this step (the decode
        working set — vLLM pins the active batch the same way)."""
        return self.store.pinned_owners

    @pinned.setter
    def pinned(self, owners) -> None:
        self.store.pinned_owners = set(owners)

    @property
    def evict_hook(self):
        return self.store.evict_hook

    @evict_hook.setter
    def evict_hook(self, fn) -> None:
        self.store.evict_hook = fn

    @property
    def reload_hook(self):
        return self.store.reload_hook

    @reload_hook.setter
    def reload_hook(self, fn) -> None:
        self.store.reload_hook = fn

    @property
    def fidelity_fn(self):
        return self.store.fidelity_fn

    @fidelity_fn.setter
    def fidelity_fn(self, fn) -> None:
        self.store.fidelity_fn = fn

    # ------------------------------------------------------------- alloc
    def allocate_block(self, req: int, block_idx: int, base_pos: int
                       ) -> Tuple[int, List[ReloadOp]]:
        """Get a local slot for a new block, evicting if necessary."""
        return self.store.allocate_local((req, block_idx), base_pos=base_pos)

    # ------------------------------------------------------ shared blocks
    def resolve(self, bid: BlockId) -> ObjectKey:
        """The store key a logical block id actually reads: its adopted
        content key when shared, else the id itself."""
        return self.shared.get(bid, bid)

    def adopt_block(self, req: int, block_idx: int, ckey: ObjectKey
                    ) -> List[ReloadOp]:
        """Lease a prefix-cache content block as this request's block
        ``block_idx`` — zero copy.  The entry is made local (the returned
        reloads are the ONLY cost a cache hit pays), pinned for the term
        of the lease (the decode read set must not churn mid-step), and
        its refcount incremented so no other owner's retire can free it.
        The caller must have checked :meth:`lessee_of` — double-leasing
        is a programming error (two batch rows cannot share a slot).
        """
        assert ckey not in self.lessee, \
            f"content block {ckey} already leased to request " \
            f"{self.lessee[ckey]} — COW-split instead"
        ops = self.store.ensure_local(ckey)
        self.store.incref(ckey)
        self.store.pin(ckey)
        self.lessee[ckey] = req
        self.shared[(req, block_idx)] = ckey
        return ops

    def lessee_of(self, ckey: ObjectKey) -> Optional[int]:
        """The request currently leasing a content block (None = free to
        adopt)."""
        return self.lessee.get(ckey)

    def cow_split(self, req: int, block_idx: int, ckey: ObjectKey
                  ) -> Tuple[int, List[ReloadOp], List[ReloadOp]]:
        """Copy-on-write split: materialise a private copy of a content
        block another live request is leasing.  Returns
        ``(slot, reload_ops, alloc_ops)`` — the reloads make the source
        local (critical path: this request's prefill reads it), the alloc
        ops are any eviction the private slot forced (write-back path).
        The engine copies the pool payload ``source slot -> slot``; the
        store payload (authoritative once evicted) is copied here so the
        private block survives its own eviction ladder independently.
        Shared blocks are never mutated: the split happens BEFORE any
        write could target the divergence block.
        """
        reload_ops = self.store.ensure_local(ckey)
        slot, alloc_ops = self.store.allocate_local(
            (req, block_idx), base_pos=block_idx * self.block_size)
        ent = self.table[(req, block_idx)]
        ent.filled = self.block_size
        src = self.store.read_payload(ckey)
        if src is not None:
            self.store.write_payload((req, block_idx), np.array(src))
        return slot, reload_ops, alloc_ops

    def release_leases(self, req: int) -> None:
        """Return every content block the request leases to the trie:
        unpin, drop the lease, and decrement the refcount (the store frees
        only when the trie no longer holds the block either)."""
        for bid in [b for b in self.shared if b[0] == req]:
            ckey = self.shared.pop(bid)
            if self.lessee.get(ckey) == req:
                del self.lessee[ckey]
            ent = self.store.table.get(ckey)
            if ent is not None:
                ent.pinned = False
                self.store.release(ckey)

    def free_request(self, req: int) -> None:
        """Release a request's blocks — through the refcount: leased
        content blocks drop one reference (never freed out from under the
        trie or a later lessee), private blocks free immediately."""
        self.release_leases(req)
        self.store.release_owner(req)

    # ----------------------------------------------------------- evict
    def evict_request(self, req: int) -> List[ReloadOp]:
        """Preemption support (paper §6.3): push ALL of a request's local
        blocks out to the peer/host tiers."""
        return self.store.evict_owner(req)

    # ----------------------------------------------------------- reload
    def ensure_resident(self, req: int, block_idx: int) -> List[ReloadOp]:
        """Fetch-mode reload: make a block local before the step."""
        return self.store.ensure_local(self.resolve((req, block_idx)))

    def plan_reloads(self, bids, seen: Optional[set] = None) -> ReloadPlan:
        """Batched reload plan for the blocks a step is about to read.

        Logical ids resolve through the shared-block map first (an adopted
        prefix block plans — and dedups — under its content key, and
        ``plan.touched`` carries the resolved key so the caller's
        slot/row mapping lands on the entry the kernel actually reads).
        Deduplicates repeated keys within the step (``seen`` may be shared
        across calls to extend the dedup window), attaches the in-flight
        transfer of any block that is already being moved — a block needed
        by both a prefetch and the critical path submits ONCE, with the
        critical waiter riding the existing transfer — and stops at the
        first LOST block (``plan.lost``) so the caller can recompute, with
        the ops planned before it still charged.
        """
        plan = ReloadPlan()
        seen = set() if seen is None else seen
        for bid in bids:
            bid = self.resolve(bid)
            if bid in seen:
                plan.deduped += 1
                self.stats["reload_deduped"] += 1
                continue
            seen.add(bid)
            if bid not in self.store.table:
                continue
            if self.store.is_lost(bid):
                plan.lost = bid
                break
            ops = self.store.ensure_local(bid)
            plan.ops.extend(ops)
            plan.touched.append(bid)
            if not ops:
                tr = self.store.transfers.inflight_for(bid)
                if tr is not None:
                    plan.attached.append(tr)
        return plan

    def is_lost(self, req: int, block_idx: int) -> bool:
        """True iff a lossy revocation dropped this block's payload."""
        return self.store.is_lost(self.resolve((req, block_idx)))

    def device_of(self, req: int, block_idx: int) -> Optional[int]:
        """Peer device a PEER-resident block lives on (else None)."""
        return self.store.device_of(self.resolve((req, block_idx)))

    # --------------------------------------------------------- prefetch
    def plan_prefetch(self, running, waiting=(), depth: int = 1
                      ) -> List[BlockId]:
        """Blocks the next steps will read that are not local yet.

        ``running`` is an iterable of ``(req_id, pos)`` pairs: for each, the
        candidates are the blocks covering the append boundary — block
        ``pos // block_size`` through ``depth`` blocks ahead — that already
        exist in the table (a resumed request may own non-local tail
        blocks).  ``waiting`` is an iterable of request ids about to be
        re-admitted (preempted requests next in scheduler order): their
        whole resident prefix is a candidate.  LOST blocks are excluded —
        they need recompute, not a transfer.  Candidates are ordered
        running-first (nearest deadline) and deduplicated; the
        :class:`~repro_torch.core.prefetch.Prefetcher` applies slot and link
        budgets on top.
        """
        out: List[BlockId] = []
        seen: set = set()

        def consider(bid: BlockId) -> None:
            if bid in seen:
                return
            seen.add(bid)
            ent = self.store.table.get(bid)
            if ent is None or ent.state in (Residency.LOCAL, Residency.LOST):
                return
            out.append(bid)

        for req, pos in running:
            j0 = pos // self.block_size
            for j in range(j0, j0 + depth + 1):
                consider((req, j))
        for req in waiting:
            for bid in self.store.owner_keys(req):
                consider(bid)
        return out

    # ------------------------------------------------------------ queries
    def residency(self, req: int) -> List[Optional[Tier]]:
        return self.store.residency_of(req)

    def tier_counts(self) -> Dict[str, int]:
        return self.store.tier_counts()

    # --------------------------------------------------------- payloads
    def write_payload(self, req: int, block_idx: int, data: np.ndarray) -> None:
        self.store.write_payload((req, block_idx), data)

    def read_payload(self, req: int, block_idx: int) -> Optional[np.ndarray]:
        return self.store.read_payload((req, block_idx))
