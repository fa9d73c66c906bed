"""Seeded workload generators: arrival processes x lengths x tenant mixes.

The paper's headline claim is throughput under *dynamic* memory
availability; whether opportunistic harvesting pays off depends on the
traffic shape it serves.  This module generates the clock-driven request
streams the :class:`~repro_torch.serving.server.HarvestServer` consumes:

  * **arrival processes** (all on the simulated transfer-engine clock,
    seeded and deterministic): ``poisson`` (memoryless open-loop
    arrivals), ``bursty`` (on/off: exponential bursts separated by idle
    gaps — the regime where admission policy decides stability),
    ``diurnal`` (a sinusoidal rate ramp thinned from a Poisson majorant —
    the daily traffic swell harvesting rides), and ``trace`` (replay of
    explicit arrival times);
  * **length distributions** for prompt and output tokens: fixed,
    uniform, or truncated lognormal (production prompt lengths are
    heavy-tailed — "Mind the Memory Gap", arXiv:2503.08311);
  * **tenant mixes**: weighted :class:`TenantSpec` entries crossing an
    SLO class (``latency | throughput | batch``) with per-tenant length
    distributions, priorities and deadlines.

``Workload.generate()`` returns :class:`ServeRequest`s sorted by arrival
time; the same ``(spec, seed)`` pair always yields the identical stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.scheduler import SLO_CLASSES
from repro_torch.serving.server import ServeRequest

#: length spec: an int (fixed), a (lo, hi) tuple (uniform, inclusive lo,
#: exclusive hi), or {"lognormal": (mean, sigma), "lo": .., "hi": ..}
LengthSpec = Union[int, Tuple[int, int], Dict]


def sample_length(rng: np.random.Generator, spec: LengthSpec) -> int:
    if isinstance(spec, int):
        if spec <= 0:
            raise ValueError(f"fixed length must be positive, got {spec}")
        return spec
    if isinstance(spec, dict):
        mean, sigma = spec["lognormal"]
        lo, hi = spec.get("lo", 1), spec.get("hi", 1 << 30)
        return int(np.clip(round(rng.lognormal(mean, sigma)), lo, hi))
    lo, hi = spec
    if not 0 < lo < hi:
        raise ValueError(f"uniform length bounds must satisfy 0 < lo < hi, "
                         f"got ({lo}, {hi})")
    return int(rng.integers(lo, hi))


# --------------------------------------------------------------- arrivals
def poisson_arrivals(rng: np.random.Generator, rate: float, n: int
                     ) -> np.ndarray:
    """Open-loop memoryless arrivals at ``rate`` req/s (simulated)."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(rng: np.random.Generator, rate: float, n: int, *,
                    burst: int = 4, duty: float = 0.25) -> np.ndarray:
    """On/off arrivals: bursts of ``burst`` back-to-back Poisson arrivals
    at ``rate / duty`` (the on-phase rate), separated by off gaps sized so
    the *long-run* rate is still ``rate``.  ``duty`` is the fraction of
    time spent in the on phase."""
    if not 0 < duty <= 1:
        raise ValueError(f"duty must be in (0, 1], got {duty}")
    if burst <= 0:
        raise ValueError(f"burst must be positive, got {burst}")
    on_rate = rate / duty
    gap_mean = burst / rate * (1.0 - duty)
    times, t = [], 0.0
    while len(times) < n:
        for _ in range(min(burst, n - len(times))):
            t += rng.exponential(1.0 / on_rate)
            times.append(t)
        t += rng.exponential(gap_mean) if gap_mean > 0 else 0.0
    return np.asarray(times)


def diurnal_arrivals(rng: np.random.Generator, rate: float, n: int, *,
                     peak_ratio: float = 3.0,
                     period_s: Optional[float] = None) -> np.ndarray:
    """Sinusoidal rate ramp (mean ``rate``, peak ``peak_ratio *`` trough)
    thinned from a Poisson majorant — a compressed day on the simulated
    clock.  ``period_s`` defaults to the span ``n`` mean-rate arrivals
    cover, so one run sees one full swell."""
    if peak_ratio < 1:
        raise ValueError(f"peak_ratio must be >= 1, got {peak_ratio}")
    if period_s is None:
        period_s = n / rate
    # lambda(t) = rate * (1 + a*sin(2 pi t / T)), a in [0, 1)
    a = (peak_ratio - 1.0) / (peak_ratio + 1.0)
    lam_max = rate * (1.0 + a)
    times, t = [], 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / lam_max)
        lam = rate * (1.0 + a * np.sin(2 * np.pi * t / period_s))
        if rng.uniform() * lam_max <= lam:
            times.append(t)
    return np.asarray(times)


def diurnal_arrivals_bulk(rng: np.random.Generator, rate: float, n: int, *,
                          peak_ratio: float = 3.0,
                          period_s: Optional[float] = None) -> np.ndarray:
    """Vectorized :func:`diurnal_arrivals` for million-request traces.

    Same sinusoidal thinned-Poisson process, but candidates are drawn and
    thinned in numpy chunks instead of one Python-loop draw at a time
    (~100x faster at n=1e6).  Deterministic given ``rng``, but NOT
    draw-for-draw identical to the scalar generator — the chunked
    thinning consumes the random stream in a different order (all gaps,
    then all acceptance uniforms, per chunk), so the same seed yields a
    different (equally valid) realisation of the same process.  Use the
    scalar generator where seed-stable goldens matter; use this for
    scale sweeps where only the process matters.
    """
    if peak_ratio < 1:
        raise ValueError(f"peak_ratio must be >= 1, got {peak_ratio}")
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    if period_s is None:
        period_s = n / rate
    a = (peak_ratio - 1.0) / (peak_ratio + 1.0)
    lam_max = rate * (1.0 + a)
    out = np.empty(n)
    filled, t = 0, 0.0
    while filled < n:
        # majorant acceptance averages 1/(1+a) >= 1/2 — oversample ~2.2x
        # so most traces finish in one or two chunks
        m = max(1024, int((n - filled) * 2.2))
        ts = t + np.cumsum(rng.exponential(1.0 / lam_max, size=m))
        lam = rate * (1.0 + a * np.sin(2 * np.pi * ts / period_s))
        acc = ts[rng.uniform(size=m) * lam_max <= lam]
        take = min(acc.size, n - filled)
        out[filled:filled + take] = acc[:take]
        filled += take
        t = float(ts[-1])
    return out


def ramp_arrivals(rng: np.random.Generator, rate: float, n: int, *,
                  start_ratio: float = 0.25,
                  end_ratio: float = 2.5,
                  ramp_s: Optional[float] = None) -> np.ndarray:
    """Linear rate ramp from ``start_ratio * rate`` to ``end_ratio *
    rate`` over ``ramp_s`` seconds (then held at the end rate), thinned
    from a Poisson majorant.

    The stability-controller's adversarial scenario: pick ratios that
    straddle the engine's saturation point and the ramp drives the
    system *through* the knee instead of parking on one side of it.
    ``ramp_s`` defaults to the span ``n`` arrivals cover at the ramp's
    mean rate, so one run sees the whole climb."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    if not 0 < start_ratio < end_ratio:
        raise ValueError(f"need 0 < start_ratio < end_ratio, got "
                         f"({start_ratio}, {end_ratio})")
    if ramp_s is None:
        ramp_s = n / (rate * 0.5 * (start_ratio + end_ratio))
    if ramp_s <= 0:
        raise ValueError(f"ramp_s must be positive, got {ramp_s}")
    lam_max = rate * end_ratio
    times, t = [], 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / lam_max)
        frac = min(t / ramp_s, 1.0)
        lam = rate * (start_ratio + (end_ratio - start_ratio) * frac)
        if rng.uniform() * lam_max <= lam:
            times.append(t)
    return np.asarray(times)


def flood_arrivals(rng: np.random.Generator, rate: float, n: int, *,
                   flood_ratio: float = 6.0,
                   flood_start: float = 0.3,
                   flood_frac: float = 0.4) -> np.ndarray:
    """Piecewise-constant rate with one flood window: ``rate`` outside,
    ``flood_ratio * rate`` inside ``[T*flood_start,
    T*(flood_start+flood_frac))`` where ``T`` is the span ``n`` arrivals
    cover at the blended mean rate — one tenant suddenly flooding an
    otherwise steady mix.  Thinned from a Poisson majorant."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    if flood_ratio < 1:
        raise ValueError(f"flood_ratio must be >= 1, got {flood_ratio}")
    if not (0.0 <= flood_start and flood_frac > 0.0
            and flood_start + flood_frac <= 1.0):
        raise ValueError(
            f"flood window must satisfy 0 <= flood_start, flood_frac > 0, "
            f"flood_start + flood_frac <= 1; got "
            f"({flood_start}, {flood_frac})")
    mean_rate = rate * (1.0 + (flood_ratio - 1.0) * flood_frac)
    span = n / mean_rate
    lo, hi = span * flood_start, span * (flood_start + flood_frac)
    lam_max = rate * flood_ratio
    times, t = [], 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / lam_max)
        lam = lam_max if lo <= t < hi else rate
        if rng.uniform() * lam_max <= lam:
            times.append(t)
    return np.asarray(times)


def trace_arrivals(times: Sequence[float]) -> np.ndarray:
    """Replay explicit arrival times (must be sorted, non-negative)."""
    arr = np.asarray(list(times), dtype=float)
    if arr.size and (np.any(np.diff(arr) < 0) or arr[0] < 0):
        raise ValueError("trace arrival times must be sorted and >= 0")
    return arr


ARRIVALS = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
            "diurnal": diurnal_arrivals, "ramp": ramp_arrivals,
            "flood": flood_arrivals}


# ---------------------------------------------------------------- tenants
@dataclass(frozen=True)
class TenantSpec:
    """One traffic class in a multi-tenant mix.

    ``prefix_share`` is the fraction of this tenant's requests that carry
    a shared system prompt, drawn from a per-tenant pool of
    ``num_prefixes`` prompts of length ``prefix_len`` (prepended to the
    request's own body).  This is the traffic shape the harvested prefix
    cache (:mod:`repro_torch.core.prefix_cache`) monetises — production
    multi-tenant serving is dominated by a few system prompts per tenant.
    The default 0.0 generates the legacy stream bit-exactly.
    """
    name: str
    weight: float = 1.0
    slo: str = "throughput"            # latency | throughput | batch
    priority: int = 0
    prompt_len: LengthSpec = (5, 40)
    max_new_tokens: LengthSpec = 16
    ttft_slo_s: Optional[float] = None
    e2e_slo_s: Optional[float] = None
    prefix_share: float = 0.0          # fraction carrying a shared prefix
    num_prefixes: int = 4              # size of the tenant's prompt pool
    prefix_len: LengthSpec = 32        # shared system-prompt length

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be positive, "
                             f"got {self.weight}")
        if self.slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {self.slo!r}; expected "
                             f"one of {SLO_CLASSES}")
        if not 0.0 <= self.prefix_share <= 1.0:
            raise ValueError(f"prefix_share must be in [0, 1], "
                             f"got {self.prefix_share}")
        if self.num_prefixes <= 0:
            raise ValueError(f"num_prefixes must be positive, "
                             f"got {self.num_prefixes}")


@dataclass
class Workload:
    """A seeded, clock-driven request stream.

    ``arrival`` names a generator in :data:`ARRIVALS` (or ``"trace"``
    with explicit ``arrival_kwargs={"times": [...]}``); ``rate`` is
    requests per *simulated* second on the transfer-engine clock.  Each
    arrival draws a tenant by weight, then that tenant's lengths.
    """
    num_requests: int = 8
    arrival: str = "poisson"
    rate: float = 1000.0
    seed: int = 0
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)
    arrival_kwargs: Dict = field(default_factory=dict)
    vocab: Tuple[int, int] = (3, 250)   # prompt token id range
    start_t: float = 0.0                # offset on the engine clock

    def __post_init__(self):
        if self.num_requests <= 0:
            raise ValueError(f"num_requests must be positive, "
                             f"got {self.num_requests}")
        if not self.tenants:
            raise ValueError("a workload needs at least one tenant")
        if self.arrival != "trace" and self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"expected one of "
                             f"{(*ARRIVALS, 'trace')}")

    def generate(self) -> List[ServeRequest]:
        # independent child streams for arrival times vs request bodies vs
        # shared prefixes: the arrival process may consume a rate-dependent
        # number of draws (diurnal thinning), and the cross-rate invariant
        # "rate re-times but never re-draws prompts" must hold structurally.
        # The prefix stream is third, so enabling prefix_share never
        # perturbs the two legacy streams (seed-stable goldens).
        arrival_rng, rng, prefix_rng = (
            np.random.default_rng(s) for s in
            np.random.SeedSequence(self.seed).spawn(3))
        if self.arrival == "trace":
            times = trace_arrivals(self.arrival_kwargs["times"])
            if len(times) != self.num_requests:
                raise ValueError(
                    f"trace has {len(times)} arrivals but num_requests="
                    f"{self.num_requests}")
        else:
            times = ARRIVALS[self.arrival](arrival_rng, self.rate,
                                           self.num_requests,
                                           **self.arrival_kwargs)
        weights = np.asarray([t.weight for t in self.tenants])
        weights = weights / weights.sum()
        picks = rng.choice(len(self.tenants), size=self.num_requests,
                           p=weights)
        lo, hi = self.vocab
        # per-tenant shared system-prompt pools, from the prefix stream
        pools: Dict[str, List[List[int]]] = {
            ten.name: [list(prefix_rng.integers(
                lo, hi, size=sample_length(prefix_rng, ten.prefix_len)))
                for _ in range(ten.num_prefixes)]
            for ten in self.tenants if ten.prefix_share > 0}
        out: List[ServeRequest] = []
        for t, pick in zip(times, picks):
            ten = self.tenants[pick]
            n_prompt = sample_length(rng, ten.prompt_len)
            n_out = sample_length(rng, ten.max_new_tokens)
            prompt = list(rng.integers(lo, hi, size=n_prompt))
            if ten.prefix_share > 0 and \
                    prefix_rng.random() < ten.prefix_share:
                pool = pools[ten.name]
                prompt = pool[int(prefix_rng.integers(len(pool)))] + prompt
            out.append(ServeRequest(
                prompt=prompt,
                max_new_tokens=n_out,
                arrival_t=self.start_t + float(t),
                slo=ten.slo, priority=ten.priority, tenant=ten.name,
                ttft_slo_s=ten.ttft_slo_s, e2e_slo_s=ten.e2e_slo_s))
        return out
