"""Placement policies for the Harvest controller.

The paper's prototype uses best-fit; §3.2 names locality, fairness,
interference and stability as alternative objectives.  All are implemented
here as composable rankers: a policy orders candidate peer devices for a
request, the allocator takes the first that fits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class PlacementRequest:
    size: int
    client: str = "default"
    hints: dict = field(default_factory=dict)   # e.g. {"requester_device": 3}


class PlacementPolicy:
    def rank(self, devices: Dict[int, dict], req: PlacementRequest) -> List[int]:
        raise NotImplementedError

    def on_alloc(self, req: PlacementRequest, device_id: int) -> None:
        pass


class BestFitPolicy(PlacementPolicy):
    """Minimise leftover contiguous space (the paper's default)."""

    def rank(self, devices, req):
        fitting = [(d, v) for d, v in devices.items()
                   if v["largest_free"] >= req.size]
        fitting.sort(key=lambda kv: kv[1]["largest_free"] - req.size)
        return [d for d, _ in fitting]


class WorstFitPolicy(PlacementPolicy):
    """Maximise leftover space (lower fragmentation under churn)."""

    def rank(self, devices, req):
        fitting = [(d, v) for d, v in devices.items()
                   if v["largest_free"] >= req.size]
        fitting.sort(key=lambda kv: -(kv[1]["largest_free"] - req.size))
        return [d for d, _ in fitting]


class LocalityPolicy(PlacementPolicy):
    """Prefer ICI-adjacent peers (paper §8: topology-aware placement).

    Distance = ring hop count on the device ring; ties broken best-fit.
    """

    def __init__(self, num_devices: int):
        self.n = num_devices

    def _dist(self, a: int, b: int) -> int:
        d = abs(a - b) % self.n
        return min(d, self.n - d)

    def rank(self, devices, req):
        src = req.hints.get("requester_device", 0)
        fitting = [(d, v) for d, v in devices.items()
                   if v["largest_free"] >= req.size]
        fitting.sort(key=lambda kv: (self._dist(src, kv[0]),
                                     kv[1]["largest_free"] - req.size))
        return [d for d, _ in fitting]


class StabilityPolicy(PlacementPolicy):
    """Prefer peers with low budget churn (fewer future revocations)."""

    def rank(self, devices, req):
        fitting = [(d, v) for d, v in devices.items()
                   if v["largest_free"] >= req.size]
        fitting.sort(key=lambda kv: (kv[1]["churn"],
                                     kv[1]["largest_free"] - req.size))
        return [d for d, _ in fitting]


class TopologyAwarePolicy(PlacementPolicy):
    """Bandwidth-weighted best-fit that knows the interconnect (paper §8).

    Candidate devices are scored by the *expected cost of using them*:

      * the transfer time of this object over the device's own
        :class:`~repro_torch.core.tiers.LinkSpec` (a striped 4-link ICI peer
        beats a distant single-path one; a PCIe-switch peer is a last
        resort);
      * a churn penalty — devices whose harvestable budget moves a lot
        (high EWMA of ``|budget delta|``) are likely to revoke, so the
        expected cost of placing there includes a re-fetch;
      * a spread penalty — recently chosen devices are deprioritised so
        concurrent placements fan out across link *lanes* instead of
        serialising on one peer's FIFO; hot objects (``hints["hot"]``)
        spread harder, because they are the ones whose reloads contend.

    Shared prefix-cache blocks (``hints["refs"] > 0`` — leased trie
    interiors) scale the churn penalty up by their reference count: a
    revocation there costs every future request that would have hit the
    prefix, so such blocks steer toward stable peers even when a churny
    one is nearer.

    Ties resolve best-fit (tightest remaining segment), so on a
    single-peer topology the ranking degenerates to the paper's default.
    """

    def __init__(self, topology, churn_weight: float = 4.0,
                 spread_weight: float = 0.5, decay: float = 0.5):
        self.topology = topology
        self.churn_weight = churn_weight
        self.spread_weight = spread_weight
        self.decay = decay
        #: runtime multiplier on the churn penalty — the stability
        #: controller raises it during revocation storms so placement
        #: backs off volatile peers; 1.0 (the default) is bit-exact with
        #: the pre-controller ranking
        self.churn_scale = 1.0
        self._recent: Dict[int, float] = {}   # EWMA of recent placements

    def rank(self, devices, req):
        from repro_torch.core.tiers import Tier
        fitting = [(d, v) for d, v in devices.items()
                   if v["largest_free"] >= req.size]
        hot = 1.0 + float(req.hints.get("hot", 0.0) or 0.0)
        refs = 1.0 + float(req.hints.get("refs", 0) or 0)

        def score(d, v):
            t = self.topology.transfer_time(req.size, Tier.PEER_HBM,
                                            Tier.LOCAL_HBM, device=d)
            churn = v["churn"] / max(v["budget"], 1)
            lane = self._recent.get(d, 0.0)
            return t * (1.0 + self.churn_weight * self.churn_scale
                        * refs * churn
                        + self.spread_weight * hot * lane)

        fitting.sort(key=lambda kv: (score(*kv),
                                     kv[1]["largest_free"] - req.size))
        return [d for d, _ in fitting]

    def on_alloc(self, req, device_id):
        for d in list(self._recent):
            self._recent[d] *= self.decay
        self._recent[device_id] = self._recent.get(device_id, 0.0) + 1.0


class FairnessPolicy(PlacementPolicy):
    """Per-client byte budget wrapped around an inner policy."""

    def __init__(self, inner: PlacementPolicy, per_client_bytes: int):
        self.inner = inner
        self.cap = per_client_bytes
        self.usage: Dict[str, int] = {}

    def rank(self, devices, req):
        if self.usage.get(req.client, 0) + req.size > self.cap:
            return []
        return self.inner.rank(devices, req)

    def on_alloc(self, req, device_id):
        self.usage[req.client] = self.usage.get(req.client, 0) + req.size
        self.inner.on_alloc(req, device_id)

    def on_free(self, client: str, size: int):
        self.usage[client] = max(0, self.usage.get(client, 0) - size)


POLICIES = {
    "best_fit": BestFitPolicy,
    "worst_fit": WorstFitPolicy,
    "locality": LocalityPolicy,
    "stability": StabilityPolicy,
    "topology": TopologyAwarePolicy,     # requires a Topology argument
}


# ---------------------------------------------------------------------------
# fidelity policy (per-SLO-class demotion precision)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FidelityPolicy:
    """What precision a KV block demotes at, per SLO class.

    ``mode``:
      off    — every demotion stays FP16 (the seed behaviour).
      slo    — per-class mapping: latency-class blocks keep FP16 (their
               tokens must be bit-identical to the fidelity-off baseline),
               throughput/batch classes quantize on demote and dequantize
               on critical reload.  Shared prefix-trie blocks keep
               ``shared`` fidelity (FP16 by default) because one quantized
               demotion would degrade every future adopter of the prefix,
               including latency-class hits.
      always — every demotion (shared blocks included) rides ``batch``'s
               fidelity; the maximum-capacity setting for offline fleets.
    """
    mode: str = "slo"
    latency: "Fidelity" = None           # type: ignore[assignment]
    throughput: "Fidelity" = None        # type: ignore[assignment]
    batch: "Fidelity" = None             # type: ignore[assignment]
    shared: "Fidelity" = None            # type: ignore[assignment]

    def __post_init__(self):
        from repro_torch.core.tiers import Fidelity
        if self.mode not in ("off", "slo", "always"):
            raise ValueError(f"FidelityPolicy: unknown mode {self.mode!r} — "
                             "one of ('off', 'slo', 'always')")
        defaults = {"latency": Fidelity.FP16, "throughput": Fidelity.INT8,
                    "batch": Fidelity.INT8, "shared": Fidelity.FP16}
        for name, default in defaults.items():
            val = getattr(self, name)
            if val is None:
                object.__setattr__(self, name, default)
            elif not isinstance(val, Fidelity):
                raise TypeError(f"FidelityPolicy.{name}: expected a "
                                f"Fidelity, got {val!r}")

    def fidelity_for(self, slo: Optional[str],
                     shared: bool = False) -> "Fidelity":
        """The demotion fidelity for a block owned by an ``slo``-class
        request (``shared=True`` for prefix-trie content blocks)."""
        from repro_torch.core.tiers import Fidelity
        if self.mode == "off":
            return Fidelity.FP16
        if self.mode == "always":
            return self.batch
        if shared:
            return self.shared
        return {"latency": self.latency, "throughput": self.throughput,
                "batch": self.batch}.get(slo or "", Fidelity.FP16)


def _fidelity_policy_presets() -> Dict[str, FidelityPolicy]:
    return {
        "off": FidelityPolicy(mode="off"),
        "slo": FidelityPolicy(mode="slo"),
        "always": FidelityPolicy(mode="always"),
    }


#: CLI-facing presets (``--fidelity-policy`` on launch/serve.py)
FIDELITY_POLICIES = _fidelity_policy_presets()
