"""Closed-loop stability control for the harvest serving engine.

Every admission/fidelity/prefetch policy shipped so far is *static*: a
diurnal ramp through the saturation point, a correlated peer-revocation
storm, or one tenant flooding a multi-tenant mix pushes the engine past
its stability region with no recourse but queue blowup.  This module
closes the loop:

  estimators  ->  stability region  ->  controller (actuators)

* **Online estimators** — per-SLO-class windowed arrival rates, EWMA
  service times / KV block-seconds (seeded from arrival-time
  predictions, switched to retire-time actuals once enough requests
  complete), and an effective harvestable-capacity estimate that
  discounts volatile peer memory by the observed revocation rate
  (``monitor.*``/``allocator.revocations`` counters).

* **Stability region** — the queueing-theoretic condition of Nie et
  al. (arXiv:2605.04595) adapted to the harvest pools: the system is
  stable iff KV demand ``sum_c lam_c * E[KV block-seconds]_c`` stays
  below the effective block supply *and* row demand
  ``lam * E[service]`` stays below the batch rows.  ``rho`` is the max
  of the two utilisations; engagement is hysteretic (enter above
  ``enter_rho``, exit below ``exit_rho``) so the controller does not
  chatter at the knee.

* **Actuators** (all gated on ``engaged`` — a controller that never
  engages is a provable no-op, bit-exact in tokens *and* clock):

  ===================  ====================================================
  admission            :class:`repro_torch.serving.admission.StabilityAdmission`
                       sheds deadline-unreachable work, bounds the pinned
                       working set to ``eff * (1 - headroom)`` blocks
  batch-size cap       regime-dependent cap on the engine refill loop
                       ("Mind the Memory Gap", arXiv:2503.08311: past the
                       weights/flops crossover a bigger batch only adds
                       KV pressure)
  prefetch budget      scales :class:`~repro_torch.core.prefetch.Prefetcher`
                       window/inflight budgets down when revocations spike
  harvest appetite     scales the churn penalty of
                       :class:`~repro_torch.core.policy.TopologyAwarePolicy` up
                       so placement avoids storming peers
  ===================  ====================================================

The controller ticks on the transfer-engine clock (``poll(now)``, same
drive pattern as :class:`repro_torch.core.monitor.PeerMonitor`) and publishes
its state as ``ctrl.*`` metrics plus a one-line :meth:`summary`.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple

from repro_torch.serving.scheduler import SLO_CLASSES

__all__ = [
    "WindowedRate", "WindowedSum", "EwmaMean", "ControllerConfig",
    "StabilityController",
]


# --------------------------------------------------------------- estimators
class WindowedRate:
    """Sliding-window event rate: ``count(window) / window_s``.

    Events are observed at (non-decreasing) clock timestamps; the rate
    at ``now`` counts events in ``(now - window_s, now]``.  Unbiased for
    a Poisson process (relative error ~ ``1/sqrt(lam * window_s)``).

    **Cold start.**  Before a full window has elapsed since the first
    event, dividing by ``window_s`` underestimates a sustained rate by
    ``elapsed / window_s`` — enough to hide a burst from the stability
    region until its deadlines are already blown.  Once a few events
    exist (``MIN_COLD_EVENTS``, so a lone early pair cannot fake a
    spike) the rate divides by the elapsed span instead, converging to
    the plain windowed estimate as ``elapsed`` reaches ``window_s``.
    """

    #: events required before the cold-start (elapsed-span) estimate is
    #: trusted over the conservative full-window division
    MIN_COLD_EVENTS = 4

    __slots__ = ("window_s", "_events", "_t0")

    def __init__(self, window_s: float):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._events: Deque[float] = deque()
        self._t0: Optional[float] = None

    def observe(self, t: float) -> None:
        if self._t0 is None:
            self._t0 = t
        self._events.append(t)

    def _purge(self, now: float) -> None:
        lo = now - self.window_s
        ev = self._events
        while ev and ev[0] <= lo:
            ev.popleft()

    def count(self, now: float) -> int:
        self._purge(now)
        return sum(1 for t in self._events if t <= now)

    def rate(self, now: float) -> float:
        n = self.count(now)
        span = self.window_s
        if self._t0 is not None and n >= self.MIN_COLD_EVENTS:
            elapsed = now - self._t0
            if 0.0 < elapsed < span:
                span = elapsed
        return n / span


class WindowedSum:
    """Sliding-window sum of weighted events (e.g. tokens/s)."""

    __slots__ = ("window_s", "_events")

    def __init__(self, window_s: float):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._events: Deque[Tuple[float, float]] = deque()

    def observe(self, t: float, x: float) -> None:
        self._events.append((t, x))

    def rate(self, now: float) -> float:
        lo = now - self.window_s
        ev = self._events
        while ev and ev[0][0] <= lo:
            ev.popleft()
        return sum(x for t, x in ev if t <= now) / self.window_s


class EwmaMean:
    """Exponentially-weighted mean with a sample counter.

    The first sample initialises the mean directly, so short runs are
    not biased toward zero; ``n`` lets callers gate on "enough actual
    observations to trust over the prior".
    """

    __slots__ = ("alpha", "value", "n")

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value = 0.0
        self.n = 0

    def update(self, x: float) -> float:
        self.value = x if self.n == 0 else (
            (1.0 - self.alpha) * self.value + self.alpha * x)
        self.n += 1
        return self.value

    def get(self, default: float = 0.0) -> float:
        return self.value if self.n else default


class _ClassEstimator:
    """Per-SLO-class load estimators.

    Predictions (``*_pred``) are updated on *arrival* from prompt/output
    lengths and the engine's hardware constants; actuals (``*_act``)
    from retired :class:`~repro_torch.serving.engine.RequestRecord`\\ s.  The
    ``*_hat`` accessors prefer actuals once ``min_n`` samples exist.
    """

    __slots__ = ("arrivals", "arr_count", "tokens", "blocks",
                 "service_pred", "service_act", "kv_pred", "kv_act",
                 "tpot_act")

    def __init__(self, window_s: float, alpha: float):
        self.arrivals = WindowedRate(window_s)
        self.arr_count = 0
        self.tokens = WindowedSum(window_s)
        self.blocks = EwmaMean(alpha)
        self.service_pred = EwmaMean(alpha)
        self.service_act = EwmaMean(alpha)
        self.kv_pred = EwmaMean(alpha)
        self.kv_act = EwmaMean(alpha)
        self.tpot_act = EwmaMean(alpha)

    def service_hat(self, min_n: int) -> float:
        if self.service_act.n >= min_n:
            return self.service_act.value
        return self.service_pred.get()

    def kv_seconds_hat(self, min_n: int) -> float:
        if self.kv_act.n >= min_n:
            return self.kv_act.value
        return self.kv_pred.get()


# ------------------------------------------------------------ configuration
@dataclass(frozen=True)
class ControllerConfig:
    """Knobs for :class:`StabilityController`.

    ``tick_interval_s``/``window_s`` default to multiples of the
    engine's weight-pass time at :meth:`~StabilityController.attach`
    so the loop tracks the hardware's natural timescale.
    """

    #: control-loop period on the transfer clock (None: 8x weight pass)
    tick_interval_s: Optional[float] = None
    #: arrival/token rate estimation window (None: 32 ticks)
    window_s: Optional[float] = None
    #: fraction of effective capacity kept free while engaged
    headroom: float = 0.15
    #: hysteresis: engage above, disengage below
    enter_rho: float = 1.0
    exit_rho: float = 0.7
    #: EWMA smoothing for service/KV/revocation estimates
    ewma_alpha: float = 0.25
    #: actual-sample count before actuals override arrival predictions
    min_actual_samples: int = 3
    #: engaged: shed deadline-free requests queued > factor * E[service]
    shed_wait_factor: float = 8.0
    #: deadline-reachability slack multiplier (like SLODeadlineAdmission)
    slack: float = 1.0
    #: peer-capacity discount gain vs revocation rate
    rev_gain: float = 1.0
    #: prefetch-budget throttle gain vs revocation rate (and its floor)
    prefetch_gain: float = 1.0
    min_prefetch_scale: float = 0.25
    #: churn-penalty scale gain vs revocation rate
    churn_gain: float = 4.0

    def __post_init__(self):
        if not 0.0 <= self.headroom < 0.9:
            raise ValueError(f"headroom must be in [0, 0.9), "
                             f"got {self.headroom}")
        if not 0.0 < self.exit_rho < self.enter_rho:
            raise ValueError(
                f"need 0 < exit_rho < enter_rho, got "
                f"exit={self.exit_rho} enter={self.enter_rho}")
        if self.tick_interval_s is not None and self.tick_interval_s <= 0:
            raise ValueError("tick_interval_s must be > 0")
        if self.window_s is not None and self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if not 0.0 < self.min_prefetch_scale <= 1.0:
            raise ValueError("min_prefetch_scale must be in (0, 1]")
        if self.min_actual_samples < 1:
            raise ValueError("min_actual_samples must be >= 1")


# -------------------------------------------------------------- controller
class StabilityController:
    """Closed-loop stability controller for one serving engine.

    Lifecycle: construct (optionally with a :class:`ControllerConfig`),
    pass as ``controller=`` to the engine, which calls :meth:`attach`;
    the engine then feeds :meth:`on_arrival`/:meth:`on_retire` and
    drives :meth:`poll` from its step loop.
    """

    #: counter names pre-seeded in the ``ctrl`` metrics namespace
    STAT_KEYS = ("ticks", "engages", "disengages", "engaged_ticks",
                 "shed", "deferred")

    def __init__(self, cfg: Optional[ControllerConfig] = None):
        self.cfg = cfg or ControllerConfig()
        self.engine = None
        self.engaged = False
        # region state (refreshed every tick)
        self.rho = 0.0
        self.rho_mem = 0.0
        self.rho_rows = 0.0
        self.rho_queue = 0.0
        self.eff_blocks = 0.0
        self.lam_total = 0.0
        self.rev_rate = 0.0
        # actuator state
        self.batch_cap = 0
        self.prefetch_scale = 1.0
        self.churn_scale = 1.0
        self.stats: Dict[str, float] = {k: 0 for k in self.STAT_KEYS}
        self._est: Dict[str, _ClassEstimator] = {}
        self._last_tick_t: Optional[float] = None
        self._arr_prev: Dict[str, int] = {}
        self._last_load_t: Optional[float] = None
        self._last_rev: float = 0.0
        self._last_rev_t: Optional[float] = None
        self._rev_ewma = EwmaMean(self.cfg.ewma_alpha)

    # ------------------------------------------------------------- wiring
    def attach(self, engine) -> None:
        """Bind to a :class:`~repro_torch.serving.engine.HarvestServingEngine`."""
        if self.engine is not None and self.engine is not engine:
            raise ValueError("controller is already attached to an engine")
        self.engine = engine
        self.tick_interval_s = (self.cfg.tick_interval_s
                                or 8.0 * engine._t_weights)
        self.window_s = self.cfg.window_s or 32.0 * self.tick_interval_s
        self._t_step_hat = max(engine._t_weights, engine._t_flop_tok)
        self.batch_cap = engine.B
        self.stats = engine.runtime.metrics.counters(
            "ctrl", keys=self.STAT_KEYS)
        for c in SLO_CLASSES:
            self._est[c] = _ClassEstimator(self.window_s,
                                           self.cfg.ewma_alpha)

    def _class(self, slo: str) -> _ClassEstimator:
        return self._est.get(slo) or self._est["throughput"]

    # ------------------------------------------------------ observations
    def on_arrival(self, r) -> None:
        """A request became visible to the engine at ``r.arrival_t``."""
        est = self._class(r.slo)
        est.arrivals.observe(r.arrival_t)
        est.arr_count += 1
        blocks = float(self._blocks_for(r))
        svc = self._predict_service(r)
        est.blocks.update(blocks)
        est.service_pred.update(svc)
        est.kv_pred.update(blocks * svc)

    def on_retire(self, record, blocks: int) -> None:
        """A request retired into :class:`EngineStats` (done or shed)."""
        if record.state != "done" or record.finish_t is None:
            return
        est = self._class(record.slo)
        start = record.admit_t if record.admit_t is not None \
            else record.arrival_t
        svc = max(record.finish_t - start, 0.0)
        est.service_act.update(svc)
        est.kv_act.update(float(blocks) * svc)
        est.tokens.observe(record.finish_t, float(record.output_tokens))
        if record.first_token_t is not None and record.output_tokens > 1:
            est.tpot_act.update(
                (record.finish_t - record.first_token_t)
                / (record.output_tokens - 1))

    def _blocks_for(self, r) -> int:
        e = self.engine
        return math.ceil(
            (len(r.prompt) + r.max_new_tokens + 1) / e.bs) + 1

    def _predict_service(self, r) -> float:
        e = self.engine
        prefill = max(len(r.prompt) * e._t_flop_tok, e._t_weights)
        return prefill + r.max_new_tokens * self._t_step_hat

    # --------------------------------------------------------- estimates
    def service_hat(self, slo: Optional[str] = None) -> float:
        """E[admit -> finish] seconds for ``slo`` (overall when None)."""
        m = self.cfg.min_actual_samples
        if slo is not None:
            v = self._class(slo).service_hat(m)
            if v > 0:
                return v
        vals = [e.service_hat(m) for e in self._est.values()]
        vals = [v for v in vals if v > 0]
        return sum(vals) / len(vals) if vals else self._t_step_hat

    def tpot_hat(self, slo: Optional[str] = None) -> float:
        """Per-decoded-token seconds estimate (observed, congestion
        included) — published as a gauge, NOT used for shedding."""
        if slo is not None:
            est = self._class(slo)
            if est.tpot_act.n >= self.cfg.min_actual_samples:
                return est.tpot_act.value
        for est in self._est.values():
            if est.tpot_act.n >= self.cfg.min_actual_samples:
                return est.tpot_act.value
        return self._t_step_hat

    def tpot_plan(self, slo: Optional[str] = None) -> float:
        """Per-token decode seconds admission *plans* with: the
        uncongested step floor.  The observed TPOT tail is exactly the
        congestion the engaged controller is correcting — pricing the
        remaining decode at it would shed requests the controlled
        system can in fact serve.  Shedding must only claim the
        certainly hopeless, so reachability uses the floor."""
        return self._t_step_hat

    def blocks_hat(self) -> float:
        """Arrival-rate-weighted mean KV blocks per request."""
        num = den = 0.0
        for est in self._est.values():
            w = max(float(est.arrivals.count(self._now())),
                    1.0 if est.blocks.n else 0.0)
            num += w * est.blocks.get()
            den += w
        return num / den if den > 0 else 1.0

    def block_budget(self, view=None) -> int:
        """Engaged working-set bound: ``eff * (1 - headroom)`` blocks,
        floored at the local pool — local slots cannot be revoked, so
        the headroom discount only guards expansion into the *harvested*
        surplus.  Without the floor a revocation storm (eff collapsing
        toward ``n_slots``) would veto admission even onto rows the
        local pool sustains, and deferred requests age into shed."""
        eff = int(self.eff_blocks * (1.0 - self.cfg.headroom))
        local = self.engine.n_slots if self.engine is not None else 1
        return max(eff, local, 1)

    def shed_wait_s(self) -> float:
        return self.cfg.shed_wait_factor * self.service_hat()

    def _now(self) -> float:
        return self.engine._now() if self.engine is not None else 0.0

    def _revocation_total(self) -> float:
        rt = self.engine.runtime
        mon = rt.metrics.counters("monitor")
        alloc = rt.allocator.stats
        return float(max(mon.get("revocations", 0),
                         alloc.get("revocations", 0)))

    # ------------------------------------------------------------- ticks
    def poll(self, now: float) -> int:
        """Fire control ticks for the elapsed clock (monitor-style)."""
        if self._last_tick_t is None:
            self._last_tick_t = now
            self._last_rev = self._revocation_total()
            self._last_rev_t = now
            return 0
        n = int((now - self._last_tick_t) / self.tick_interval_s)
        if n <= 0:
            return 0
        self._last_tick_t += n * self.tick_interval_s
        # the tick recomputes from instantaneous estimates, so firing the
        # backlog once (at `now`) is equivalent to n identical ticks
        self.stats["ticks"] += n
        self._tick(now)
        if self.engaged:
            self.stats["engaged_ticks"] += n
        return n

    def _tick(self, now: float) -> None:
        e = self.engine
        cfg = self.cfg
        # --- revocation rate (events/s, EWMA-smoothed counter deltas)
        total = self._revocation_total()
        dt = now - (self._last_rev_t if self._last_rev_t is not None
                    else now)
        if dt > 0:
            self._rev_ewma.update((total - self._last_rev) / dt)
            self._last_rev, self._last_rev_t = total, now
        self.rev_rate = self._rev_ewma.get()
        svc = self.service_hat()
        # --- effective capacity: local blocks plus peer blocks discounted
        # by the chance a block is revoked within one service time
        peer_bytes = sum(v["budget"]
                         for v in e.runtime.allocator.device_view().values())
        peer_blocks = peer_bytes / max(e.kv_mgr.block_nbytes, 1)
        discount = 1.0 / (1.0 + cfg.rev_gain * self.rev_rate * svc)
        self.eff_blocks = e.n_slots + peer_blocks * discount
        # --- stability region: KV-block-seconds demand vs supply, and
        # row-seconds demand vs batch rows (Nie et al. 2605.04595)
        m = cfg.min_actual_samples
        # aliasing guard: one stalled step (a reload convoy under a
        # burst) can span the whole estimator window, so every arrival
        # in the burst ages out before the next observation.  When the
        # gap since the last load observation exceeds the window, the
        # inter-tick arrival count over that gap is the sharper rate
        # estimate; inside the window the trailing-window rate rules, so
        # in-region runs (fine-grained steps) are untouched.
        dt_load = (now - self._last_load_t
                   if self._last_load_t is not None else 0.0)
        kv_demand = row_demand = lam_total = 0.0
        for slo, est in self._est.items():
            lam = est.arrivals.rate(now)
            if dt_load >= self.window_s:
                prev = self._arr_prev.get(slo, 0)
                lam = max(lam, (est.arr_count - prev) / dt_load)
            self._arr_prev[slo] = est.arr_count
            lam_total += lam
            kv_demand += lam * est.kv_seconds_hat(m)
            row_demand += lam * est.service_hat(m)
        self._last_load_t = now
        self.lam_total = lam_total
        self.rho_mem = kv_demand / max(self.eff_blocks, 1e-12)
        self.rho_rows = row_demand / max(float(e.B), 1e-12)
        # standing-queue pressure: a burst that already aged out of the
        # arrival window still left its offered load in the waiting
        # queue.  The queue's drain time (at full batch) measured in
        # estimator windows is a rate-free load signal: in-region runs
        # hold at most a couple of requests (<< 1), a divergent queue
        # cannot hide.
        self.rho_queue = (len(e.waiting) * svc
                          / max(float(e.B) * self.window_s, 1e-12))
        self.rho = max(self.rho_mem, self.rho_rows, self.rho_queue)
        # --- hysteresis.  A queued request whose deadline already passed
        # is direct evidence of an out-of-region excursion (the rate
        # estimators can miss one aliased burst, its victims cannot):
        # engage to shed it rather than admit it into a blown SLO.
        if not self.engaged and (self.rho > cfg.enter_rho
                                 or self._expired_waiting(now)):
            self.engaged = True
            self.stats["engages"] += 1
        elif self.engaged and self.rho < cfg.exit_rho \
                and not self._expired_waiting(now):
            self.engaged = False
            self.stats["disengages"] += 1
        self._actuate()
        self._publish()

    def _expired_waiting(self, now: float) -> bool:
        """True while the waiting queue holds a request whose deadline
        already passed.  Disengaging at that instant would hand those
        requests to the inner policy, which admits them into a blown
        TTFT; one more engaged admission pass sheds them first, and the
        controller lets go on the next tick."""
        for r in self.engine.waiting:
            if (r.ttft_deadline_t is not None and r.first_token_t is None
                    and now > r.ttft_deadline_t):
                return True
            if r.e2e_deadline_t is not None and now > r.e2e_deadline_t:
                return True
        return False

    def _actuate(self) -> None:
        e = self.engine
        cfg = self.cfg
        if not self.engaged:
            # every actuator restored to its passive value: disengaged
            # (or never-engaged) runs are bit-exact with controller=None
            self.batch_cap = e.B
            self.prefetch_scale = 1.0
            self.churn_scale = 1.0
        else:
            # regime-dependent batch cap: memory-feasible rows, bounded by
            # the weights/flops crossover (past it a bigger batch is
            # flops-bound and only adds KV pressure)
            bstar = max(int(math.ceil(e._t_weights
                                      / max(e._t_flop_tok, 1e-30))), 1)
            bhat = max(self.blocks_hat(), 1e-12)
            # the local slot pool cannot be revoked: rows it sustains are
            # always memory-feasible, only the *harvested* surplus above
            # that is discounted under revocation pressure.  Rows are
            # counted round-to-nearest, not floored: ``blocks_hat`` is a
            # noisy EWMA, and flooring turns an estimate of 1.98
            # sustainable rows into a cap of 1 — serializing the batch
            # (and blowing every queued deadline) over estimator noise,
            # when the marginal row spills at most a block.
            local_rows = max(int(e.n_slots / bhat + 0.5), 1)
            mem_rows = max(
                int(self.eff_blocks * (1.0 - cfg.headroom) / bhat + 0.5),
                local_rows)
            self.batch_cap = max(1, min(e.B, bstar, mem_rows))
            pressure = self.rev_rate * self.service_hat()
            self.prefetch_scale = max(
                cfg.min_prefetch_scale,
                1.0 / (1.0 + cfg.prefetch_gain * pressure))
            self.churn_scale = 1.0 + cfg.churn_gain * pressure
        if e.prefetcher is not None:
            e.prefetcher.throttle = self.prefetch_scale
        pol = e.runtime.allocator.policy
        if pol is not None and hasattr(pol, "churn_scale"):
            pol.churn_scale = self.churn_scale

    def _publish(self) -> None:
        s = self.stats
        s["engaged"] = int(self.engaged)
        s["rho"] = self.rho
        s["rho_mem"] = self.rho_mem
        s["rho_rows"] = self.rho_rows
        s["rho_queue"] = self.rho_queue
        s["eff_blocks"] = self.eff_blocks
        s["lam_total"] = self.lam_total
        s["rev_rate"] = self.rev_rate
        s["batch_cap"] = self.batch_cap
        s["prefetch_scale"] = self.prefetch_scale
        s["churn_scale"] = self.churn_scale

    # ------------------------------------------------------------ report
    def summary(self) -> str:
        """One-line region + actuator state for logs and reports."""
        return (f"ctrl: rho {self.rho:.2f} "
                f"(mem {self.rho_mem:.2f} rows {self.rho_rows:.2f}) "
                f"eff {self.eff_blocks:.1f} blk "
                f"lam {self.lam_total:.3g}/s "
                f"rev {self.rev_rate:.3g}/s "
                f"{'ENGAGED' if self.engaged else 'idle'} "
                f"cap {self.batch_cap} "
                f"pf x{self.prefetch_scale:.2f} "
                f"churn x{self.churn_scale:.2f} "
                f"ticks {int(self.stats.get('ticks', 0))} "
                f"shed {int(self.stats.get('shed', 0))}")
