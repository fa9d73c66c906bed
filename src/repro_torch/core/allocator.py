"""The Harvest runtime: opportunistic peer-memory allocation with revocation.

Implements the paper's API (§3.2):

    harvest_alloc(size, hints)   -> HarvestHandle | None
    harvest_free(handle)
    harvest_register_cb(handle, cb)

A controller (:class:`HarvestAllocator`) tracks the *harvestable* byte budget
of every peer device, hands out segments from a per-device free list, and —
when external pressure shrinks a device's budget — revokes allocations in a
strict drain -> invalidate -> notify order.  Correctness never depends on a
peer allocation surviving: callers keep an authoritative copy (weights) or
reconstruct (KV/recurrent state).

The handle names a (device, offset, size)
region that higher layers map to pool-array slots.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.policy import BestFitPolicy, PlacementPolicy, PlacementRequest


@dataclass(frozen=True)
class HarvestHandle:
    """(device, offset, size) — the unique id of a peer allocation."""
    handle_id: int
    device: int
    offset: int
    size: int
    client: str = "default"

    @property
    def key(self) -> Tuple[int, int, int]:
        return (self.device, self.offset, self.size)


class RevokedError(RuntimeError):
    pass


@dataclass
class _FreeList:
    """Address-ordered free list with first/best-fit and coalescing."""
    capacity: int
    segments: List[Tuple[int, int]] = field(default_factory=list)  # (off, size)

    def __post_init__(self):
        if not self.segments:
            self.segments = [(0, self.capacity)]

    def best_fit(self, size: int) -> Optional[int]:
        best = None
        for off, seg in self.segments:
            if seg >= size and (best is None or seg < best[1]):
                best = (off, seg)
        if best is None:
            return None
        off, seg = best
        self.segments.remove((off, seg))
        if seg > size:
            self.segments.append((off + size, seg - size))
            self.segments.sort()
        return off

    def release(self, off: int, size: int) -> None:
        """Return ``[off, off+size)`` to the free list.

        A release that overlaps an already-free segment is a double free
        (or a size/offset corruption): silently coalescing it would
        fabricate free bytes and let a later allocation alias a live
        segment, so it is rejected loudly instead.
        """
        if size <= 0 or off < 0 or off + size > self.capacity:
            raise ValueError(
                f"release of [{off}, {off + size}) outside freelist "
                f"capacity {self.capacity}")
        for o, s in self.segments:
            if off < o + s and o < off + size:
                raise ValueError(
                    f"double free: released segment [{off}, {off + size}) "
                    f"overlaps free segment [{o}, {o + s})")
        self.segments.append((off, size))
        self.segments.sort()
        merged: List[Tuple[int, int]] = []
        for o, s in self.segments:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((o, s))
        self.segments = [(o, s) for o, s in merged]

    @property
    def free_bytes(self) -> int:
        return sum(s for _, s in self.segments)

    @property
    def largest_free(self) -> int:
        return max((s for _, s in self.segments), default=0)

    def fragmentation(self) -> float:
        free = self.free_bytes
        return 0.0 if free == 0 else 1.0 - self.largest_free / free


@dataclass
class _Device:
    device_id: int
    budget: int                       # harvestable bytes (can shrink/grow)
    freelist: _FreeList = None        # sized to max budget; shrink = revoke
    used: int = 0
    churn: float = 0.0                # EWMA of |budget delta| (stability policy)

    def __post_init__(self):
        if self.freelist is None:
            self.freelist = _FreeList(self.budget)


class HarvestAllocator:
    """Controller for opportunistic peer HBM allocation."""

    #: stats counter names (one namespace in the runtime's MetricsRegistry)
    STAT_KEYS = ("allocs", "failed", "revocations", "frees")

    def __init__(self, device_budgets: Dict[int, int],
                 policy: Optional[PlacementPolicy] = None,
                 metrics=None):
        self._devices: Dict[int, _Device] = {
            d: _Device(d, b) for d, b in device_budgets.items()}
        self._policy = policy or BestFitPolicy()
        self._handles: Dict[int, HarvestHandle] = {}
        self._cbs: Dict[int, Callable[[HarvestHandle], None]] = {}
        self._alloc_order: List[int] = []        # handle ids, oldest first
        self._inflight: Dict[int, int] = {}      # handle -> outstanding DMA ops
        self._ids = itertools.count(1)
        # `metrics` is a MetricsRegistry (duck-typed to avoid an import cycle
        # with repro_torch.core.store); standalone allocators keep a plain dict
        if metrics is not None:
            self.stats = metrics.counters("allocator", keys=self.STAT_KEYS)
        else:
            self.stats = {k: 0 for k in self.STAT_KEYS}

    @property
    def policy(self) -> PlacementPolicy:
        """The live placement policy (the stability controller tunes its
        churn appetite through this)."""
        return self._policy

    # ---------------------------------------------------------------- API
    def harvest_alloc(self, size: int, hints: Optional[dict] = None,
                      client: str = "default") -> Optional[HarvestHandle]:
        hints = hints or {}
        req = PlacementRequest(size=size, client=client, hints=hints)
        order = self._policy.rank(self._snapshot(), req)
        for dev_id in order:
            dev = self._devices[dev_id]
            if dev.budget - dev.used < size:
                continue
            off = dev.freelist.best_fit(size)
            if off is None:
                continue
            h = HarvestHandle(next(self._ids), dev_id, off, size, client)
            dev.used += size
            self._handles[h.handle_id] = h
            self._alloc_order.append(h.handle_id)
            self._policy.on_alloc(req, dev_id)
            self.stats["allocs"] += 1
            return h
        self.stats["failed"] += 1
        return None

    def harvest_free(self, handle: HarvestHandle) -> None:
        if handle.handle_id not in self._handles:
            raise RevokedError(f"handle {handle.handle_id} already revoked/freed")
        self._release(handle)
        self.stats["frees"] += 1

    def harvest_register_cb(self, handle: HarvestHandle,
                            cb: Callable[[HarvestHandle], None]) -> None:
        if handle.handle_id not in self._handles:
            raise RevokedError(f"handle {handle.handle_id} already revoked/freed")
        self._cbs[handle.handle_id] = cb

    # ----------------------------------------------------- DMA bookkeeping
    def begin_io(self, handle: HarvestHandle) -> None:
        self._inflight[handle.handle_id] = self._inflight.get(handle.handle_id, 0) + 1

    def end_io(self, handle: HarvestHandle) -> None:
        n = self._inflight.get(handle.handle_id, 0) - 1
        if n <= 0:
            self._inflight.pop(handle.handle_id, None)
        else:
            self._inflight[handle.handle_id] = n

    # ------------------------------------------------------- availability
    def update_budget(self, device_id: int, new_budget: int) -> List[HarvestHandle]:
        """External pressure changed a device's harvestable budget.

        If current usage exceeds the new budget, revoke allocations (newest
        first) until usage fits.  Returns the revoked handles (callbacks have
        already fired, post-drain, in revocation order).
        """
        dev = self._devices[device_id]
        dev.churn = 0.9 * dev.churn + 0.1 * abs(new_budget - dev.budget)
        dev.budget = new_budget
        revoked = []
        if dev.used > dev.budget:
            for hid in reversed(list(self._alloc_order)):
                if dev.used <= dev.budget:
                    break
                h = self._handles.get(hid)
                if h is None or h.device != device_id:
                    continue
                self._revoke(h)
                revoked.append(h)
        return revoked

    def _revoke(self, handle: HarvestHandle) -> None:
        # 1. drain in-flight DMA/kernels touching the region
        self._drain(handle)
        # 2. invalidate the placement entry
        cb = self._cbs.pop(handle.handle_id, None)
        self._release(handle)
        self.stats["revocations"] += 1
        self._bump(f"dev{handle.device}.revocations")
        # 3. notify the application
        if cb is not None:
            cb(handle)

    def _bump(self, key: str) -> None:
        # per-device keys are open-ended; standalone allocators keep a plain
        # dict, so seed on first use instead of relying on Counters
        self.stats[key] = self.stats.get(key, 0) + 1

    def _drain(self, handle: HarvestHandle) -> None:
        # Functional stand-in for stream/event synchronisation: revocation is
        # not allowed to complete while IO on the region is outstanding.
        if self._inflight.get(handle.handle_id):
            raise RuntimeError(
                f"revoking handle {handle.handle_id} with in-flight IO; "
                "callers must end_io() (stream-sync) before the runtime ticks")

    def _release(self, handle: HarvestHandle) -> None:
        dev = self._devices[handle.device]
        dev.freelist.release(handle.offset, handle.size)
        dev.used -= handle.size
        del self._handles[handle.handle_id]
        self._cbs.pop(handle.handle_id, None)
        self._alloc_order.remove(handle.handle_id)

    # ------------------------------------------------------------ queries
    def _snapshot(self) -> Dict[int, dict]:
        return {
            d.device_id: {
                "free": d.budget - d.used,
                "used": d.used,
                "largest_free": min(d.freelist.largest_free,
                                    max(d.budget - d.used, 0)),
                "fragmentation": d.freelist.fragmentation(),
                "churn": d.churn,
                "budget": d.budget,
            }
            for d in self._devices.values()
        }

    def live_handles(self) -> List[HarvestHandle]:
        return list(self._handles.values())

    def device_view(self) -> Dict[int, dict]:
        return self._snapshot()

    def is_live(self, handle: HarvestHandle) -> bool:
        return handle.handle_id in self._handles
