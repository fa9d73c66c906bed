"""Harvested prefix cache — radix-trie cross-request KV sharing.

Production traffic is dominated by shared system prompts; the KV blocks
of a shared prefix are identical across every request that carries it, so
recomputing them per request wastes exactly the prefill flops a cache
would save.  This module keeps those blocks alive *after* their request
retires, content-addressed and placed across the Harvest tiers — which is
the combination no existing system ships: a prefix cache whose cold tier
is *harvested peer GPU memory* rather than host DRAM.

Structure
---------
A radix trie keyed on chained token-block digests::

    digest_j = blake2b(digest_{j-1} || tokens[j*bs : (j+1)*bs])

so a trie path IS a prompt prefix (in full blocks) and two different
prefixes can never alias a node.  Every node owns one content-addressed
entry ``("px", digest)`` in the *same* :class:`~repro_torch.core.store.HarvestStore`
the per-request block table uses — the entry keeps its local slot (the
live pool payload), can be demoted to peer/host by the store's ordinary
LRU pressure (the trie entry needs no retargeting: the key is stable,
only the residency changes), and is reloaded through the same
:class:`~repro_torch.core.store.TransferEngine` lanes as any other block.

Lifecycle
---------
* **publish** (at retire): instead of freeing a request's full prompt
  blocks, :meth:`~repro_torch.core.store.HarvestStore.rekey` transfers each one
  to its content key — zero bytes move, the pool slot and any in-flight
  write-back follow the object.  Duplicate content (another request
  published the same prefix first) is deduplicated: the private twin is
  freed normally.
* **match** (at admission/prefill): longest-prefix walk; each matched
  block is either *adopted* zero-copy (leased: the entry is pinned local,
  its refcount incremented, and only the possibly peer→local reload is
  charged) or — when another live request already leases it — *COW-split*
  into a private copy, so a shared block is never mapped to two batch
  rows (the decode kernel's ``slot_req`` maps each slot to exactly one
  row) and never mutated.
* **evict** (capacity): leaf-first LRU over trie nodes.  A node whose
  entry is leased (``refcount > 0``) is unevictable — dropping it would
  free a block a live request reads; it stays until the lease returns.
  Interior nodes are evicted only once their children are gone (an
  orphaned descendant chain could never be matched again).

Refcount contract (shared with :class:`HarvestStore`): the trie's own
hold is the entry's *base* ownership (``refcount == 0``); every lease is
one extra reference.  ``release`` drops a reference before it frees, so
whichever of {trie eviction, lessee retire} happens last performs the
actual free — the double-free class of bugs is structurally gone.

Metrics land in the ``prefix.*`` namespace: ``hits`` / ``hit_blocks`` /
``lookup_blocks`` (hit rate), ``peer_hits`` (matched blocks that were
peer-resident — the paper's harvested-tier wins), ``cow_splits``,
``published`` / ``dedup``, ``evictions`` and ``lost_pruned``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.store import MetricsRegistry, ObjectKey, Residency
from repro_torch.core.tiers import Fidelity

#: counters pre-seeded in the ``prefix`` namespace (stable print order)
PREFIX_STAT_KEYS = (
    "lookups", "lookup_blocks", "hits", "hit_blocks", "hit_tokens",
    "local_hits", "peer_hits", "host_hits", "cow_splits",
    "published", "dedup", "relinked", "evictions", "lost_pruned", "nodes")


def block_digests(tokens: Sequence[int], block_size: int) -> List[str]:
    """Chained content digests of the FULL blocks of a token sequence.

    Only blocks entirely covered by ``tokens`` get a digest — a partial
    tail block is private to its request (its future fill diverges).
    Chaining makes each digest position-dependent: block ``j`` of prefix A
    and block ``j`` of prefix B collide only if their whole first
    ``j + 1`` blocks are identical, which is exactly the sharing
    condition for causal-attention KV state.
    """
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    out: List[str] = []
    prev = b""
    arr = np.asarray(tokens, dtype=np.int64)
    for j in range(len(arr) // block_size):
        h = hashlib.blake2b(
            prev + arr[j * block_size:(j + 1) * block_size].tobytes(),
            digest_size=16)
        prev = h.digest()
        out.append(prev.hex())
    return out


@dataclass
class PrefixCacheConfig:
    """Knobs for the prefix trie.

    ``capacity_blocks`` bounds the number of cached blocks (trie nodes);
    beyond it, leaf-first LRU eviction frees unleased entries.
    ``hot_alpha`` is the hotness-EWMA weight applied on every hit — hit
    blocks (weighted by their interior fan-out) carry higher ``hotness``
    into the store's placement hints, steering them to stable peers.
    ``fidelity`` is the precision the cache's content is addressed at:
    digest keys include it (except FP16, which keeps the seed key shape),
    so a quantized cached block can never alias — and never be served in
    place of — a full-precision one.
    """
    capacity_blocks: int = 256
    hot_alpha: float = 0.5
    fidelity: Fidelity = Fidelity.FP16

    def __post_init__(self):
        if self.capacity_blocks <= 0:
            raise ValueError(f"capacity_blocks must be positive, "
                             f"got {self.capacity_blocks}")
        if not 0.0 <= self.hot_alpha < 1.0:
            raise ValueError(f"hot_alpha must be in [0, 1), "
                             f"got {self.hot_alpha}")
        if not isinstance(self.fidelity, Fidelity):
            raise TypeError(f"fidelity must be a Fidelity, "
                            f"got {self.fidelity!r}")


@dataclass(eq=False)
class TrieNode:
    """One cached block: a radix-trie edge labelled by its chain digest."""
    digest: str
    key: ObjectKey                      # ("px", digest) in the block store
    parent: Optional["TrieNode"]
    depth: int = 0                      # block index == base_pos // bs
    children: Dict[str, "TrieNode"] = field(default_factory=dict)
    last_use: int = 0                   # trie-LRU tick


class PrefixCache:
    """Radix-trie prefix cache over one :class:`KVOffloadManager`'s store.

    The cache owns no payloads and no slots — every cached block is an
    ordinary store entry that the tier ladder (eviction to peer/host,
    revocation, reload) manages like any other.  The trie adds reachability
    (digest chain -> key), the refcount discipline, and its own capacity
    eviction on top.
    """

    def __init__(self, kv_mgr, config: Optional[PrefixCacheConfig] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.kv = kv_mgr
        self.store = kv_mgr.store
        self.bs = kv_mgr.block_size
        self.cfg = config or PrefixCacheConfig()
        self.stats = (metrics or self.store.transfers.metrics).counters(
            "prefix", keys=PREFIX_STAT_KEYS)
        self.root = TrieNode("", None, None, depth=-1)
        self.nodes: Dict[str, TrieNode] = {}     # digest -> node (1:1)
        self._tick = 0

    # ------------------------------------------------------------- helpers
    def content_key(self, digest: str) -> ObjectKey:
        """Store key of a cached block's content at the cache's fidelity.

        FP16 keeps the seed's ``("px", digest)`` shape (back-compat with
        persisted metrics/goldens); a quantized cache appends the fidelity
        value, so the same prompt content cached at different precisions
        occupies distinct, never-aliasing store entries.
        """
        if self.cfg.fidelity is Fidelity.FP16:
            return ("px", digest)
        return ("px", digest, self.cfg.fidelity.value)

    def __len__(self) -> int:
        return len(self.nodes)

    def _entry_alive(self, node: TrieNode):
        """The node's store entry, or None when it died underneath the
        trie (freed, revoked LOST, or never fully filled)."""
        ent = self.store.table.get(node.key)
        if ent is None or ent.state is Residency.LOST:
            return None
        if getattr(ent, "filled", self.bs) < self.bs:
            return None
        return ent

    def _touch(self, node: TrieNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def _unlink(self, node: TrieNode, stat: str) -> None:
        """Drop one node and its subtree from the trie, releasing each
        store entry (refcount-routed: leased entries survive as plain
        store objects until their lessee frees them)."""
        stack = [node]
        if node.parent is not None:
            node.parent.children.pop(node.digest, None)
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children.clear()
            self.nodes.pop(n.digest, None)
            if n.key in self.store.table:
                self.store.release(n.key)
            self.stats[stat] += 1
        self.stats["nodes"] = len(self.nodes)

    # -------------------------------------------------------------- lookup
    def probe(self, tokens: Sequence[int]) -> int:
        """Matched token count of the longest cached prefix — side-effect
        free (no counters, no LRU touch).  Admission-time TTFT estimates
        use this so shedding decisions see the post-cache prefill cost."""
        node = self.root
        m = 0
        for d in block_digests(tokens, self.bs):
            child = node.children.get(d)
            if child is None or self._entry_alive(child) is None:
                break
            node = child
            m += 1
        return m * self.bs

    def match(self, tokens: Sequence[int]
              ) -> List[Tuple[int, ObjectKey]]:
        """Longest-prefix lookup: ``[(block_idx, content_key), ...]`` for
        the matched chain, LRU/hotness-touched.  Dead nodes found on the
        walk (entry freed or revoked LOST) are pruned with their subtree —
        a chain with a hole can never be consistently reused."""
        self.stats["lookups"] += 1
        self.stats["lookup_blocks"] += len(tokens) // self.bs
        out: List[Tuple[int, ObjectKey]] = []
        node = self.root
        for j, d in enumerate(block_digests(tokens, self.bs)):
            child = node.children.get(d)
            if child is None:
                break
            if self._entry_alive(child) is None:
                self._unlink(child, "lost_pruned")
                break
            self._touch(child)
            # interior fan-out weights the heat: a node many prefixes pass
            # through is the one whose demotion/revocation hurts most
            self.store.touch_hotness(child.key, 1.0 + len(child.children),
                                     self.cfg.hot_alpha)
            out.append((j, child.key))
            node = child
        if out:
            self.stats["hits"] += 1
            self.stats["hit_blocks"] += len(out)
            self.stats["hit_tokens"] += len(out) * self.bs
        return out

    # ------------------------------------------------------------- publish
    def publish(self, req_id: int, prompt: Sequence[int]) -> int:
        """Retire-time publication: transfer the request's full prompt
        blocks into the trie (rekey, zero copy) instead of freeing them.

        Blocks whose content is already cached are deduplicated (the
        private twin is freed by the caller's ``free_request``); blocks
        the request itself *adopted* from the trie are simply touched.
        Publication stops at the first unpublishable block (missing,
        LOST, or partially filled) — the chain must stay contiguous.
        Returns the number of newly published blocks.
        """
        node = self.root
        new = 0
        for j, d in enumerate(block_digests(prompt, self.bs)):
            bid = (req_id, j)
            child = node.children.get(d)
            if child is not None and self._entry_alive(child) is not None:
                self._touch(child)
                if bid not in self.kv.shared:
                    self.stats["dedup"] += 1
                node = child
                continue
            if child is not None:          # dead node in the path
                self._unlink(child, "lost_pruned")
            ckey = self.content_key(d)
            if ckey in self.store.table:
                # content survives outside the trie (its node was pruned
                # while a lease held the entry alive): re-link and restore
                # the trie's base hold so the lessee's release cannot free
                ent = self.store.table[ckey]
                if ent.state is Residency.LOST or \
                        getattr(ent, "filled", self.bs) < self.bs:
                    break
                self.store.incref(ckey)
                self.stats["relinked"] += 1
            else:
                ent = self.kv.table.get(bid)
                if ent is None or ent.state is Residency.LOST \
                        or ent.filled < self.bs:
                    break
                self.store.rekey(bid, ckey)
                ent.pinned = False         # trie blocks ride the LRU ladder
                self.stats["published"] += 1
                new += 1
            child = TrieNode(d, ckey, node, depth=j)
            node.children[d] = child
            self.nodes[d] = child
            self._touch(child)
            node = child
        self.stats["nodes"] = len(self.nodes)
        self._evict_to_capacity()
        return new

    # ------------------------------------------------------------ eviction
    def _evict_to_capacity(self) -> int:
        """Leaf-first LRU trie eviction down to ``capacity_blocks``.

        Only leaves are candidates (evicting an interior node would orphan
        a still-matchable chain) and only unleased entries may be freed —
        ``refcount > 0`` blocks are locally unevictable by the trie; the
        *store* may still demote them tier-wise, which the trie does not
        even need to observe (content keys are residency-stable).
        """
        evicted = 0
        while len(self.nodes) > self.cfg.capacity_blocks:
            victim: Optional[TrieNode] = None
            for n in self.nodes.values():
                if n.children:
                    continue
                ent = self.store.table.get(n.key)
                if ent is not None and ent.refcount > 0:
                    continue               # leased: unevictable until freed
                if victim is None or n.last_use < victim.last_use:
                    victim = n
            if victim is None:
                break                      # every leaf is leased — stop
            self._unlink(victim, "evictions")
            evicted += 1
        return evicted
