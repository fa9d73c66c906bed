"""Admission policies: clock-driven gatekeepers in front of the schedulers.

The engine's FCFS/CFS schedulers decide *which row* an admissible request
takes; an :class:`AdmissionPolicy` decides *whether a queued request is
admissible at all* at the current simulated clock.  The policy sees one
:class:`AdmissionView` per scheduler step (the capacity picture at
``now``) and partitions the waiting queue into

  * **eligible** — passed to the capacity filter + scheduler, in the
    order the scheduler should consider them (a policy may reorder, e.g.
    latency-class-first);
  * **shed** — rejected now (load shedding): the engine retires them in
    state ``rejected`` without running a single prefill flop, the
    queueing-stability move when the KV-memory bound makes the queue
    divergent (Nie et al., arXiv:2605.04595).

Everything not in either list is *deferred*: it stays queued, FIFO, and
is reconsidered next step.  The base policy is unconditional (legacy
behaviour, bit-exact with the pre-lifecycle engine); ``headroom`` keeps a
reserve of local KV slots free to absorb decode growth without
preemption churn; ``deadline`` sheds requests that can no longer meet
their TTFT SLO and lets latency-class traffic jump the queue.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

from repro_torch.serving.scheduler import Request


class AdmissionView:
    """The capacity picture a policy may inspect at admission time."""

    def __init__(self, *, now: float, free_rows: int, num_slots: int,
                 pinned_blocks: int, num_running: int,
                 blocks_needed: Callable[[Request], int],
                 est_prefill_s: Callable[[Request], float],
                 pending_prefill_s: float = 0.0):
        self.now = now
        self.free_rows = free_rows
        self.num_slots = num_slots              # local KV pool capacity
        self.pinned_blocks = pinned_blocks      # running working sets
        self.num_running = num_running
        self.blocks_needed = blocks_needed      # per-request working set
        self.est_prefill_s = est_prefill_s      # lower-bound service time
        #: prefill seconds already committed ahead of this admission pass
        #: (in-flight chunked prefills of running requests)
        self.pending_prefill_s = pending_prefill_s


class AdmissionPolicy:
    """Unconditional admission: every queued request is eligible, in FIFO
    order.  This is the legacy (and default) behaviour."""

    name = "all"

    def select(self, waiting: List[Request], view: AdmissionView
               ) -> Tuple[List[Request], List[Request]]:
        """Return ``(eligible_in_order, shed)``."""
        return list(waiting), []


class KVHeadroomAdmission(AdmissionPolicy):
    """KV-headroom-aware admission: only admit while the projected pinned
    working set leaves ``headroom_frac`` of the local pool free.

    Admitting up to the brim forces the fair scheduler into eviction
    churn the moment any running request grows a block; holding a reserve
    trades queue wait for fewer preemption-induced reloads.  When nothing
    is running the head-of-line request is always eligible — a pool
    smaller than the reserve must not deadlock the server.
    """

    name = "headroom"

    def __init__(self, headroom_frac: float = 0.25):
        if not 0.0 <= headroom_frac < 1.0:
            raise ValueError(
                f"headroom_frac must be in [0, 1), got {headroom_frac}")
        self.headroom_frac = headroom_frac

    def select(self, waiting, view):
        cap = view.num_slots * (1.0 - self.headroom_frac)
        pinned = view.pinned_blocks
        eligible: List[Request] = []
        for r in waiting:
            need = view.blocks_needed(r)
            if pinned + need > cap:
                if not eligible and view.num_running == 0:
                    eligible.append(r)   # starvation guard
                break                    # defer the rest, keep FIFO
            pinned += need
            eligible.append(r)
        return eligible, []


class SLODeadlineAdmission(AdmissionPolicy):
    """SLO-deadline-aware admission: shed what cannot make its deadline,
    serve the latency class first.

    A queued request whose TTFT deadline is already unreachable (its
    prefill alone lands past the deadline) is shed immediately instead
    of burning prefill compute on a token that arrives too late; the
    survivors are ordered priority-desc, deadline-asc, then FIFO.
    Requests that already produced a token are never shed — their TTFT is
    history and their KV investment is sunk.

    The reachability check walks the queue in admission order carrying a
    prefill *backlog*: the in-flight chunked-prefill seconds the engine
    already committed (``view.pending_prefill_s``) plus the estimated
    prefill of every request kept ahead in this same pass.  Without the
    backlog each request is judged as if it would prefill first, so the
    policy admits a convoy whose tail it then misses.
    """

    name = "deadline"

    def __init__(self, slack: float = 1.0):
        if slack <= 0:
            raise ValueError(f"slack must be positive, got {slack}")
        self.slack = slack

    def select(self, waiting, view):
        inf = float("inf")
        order = sorted(waiting, key=lambda r: (
            -r.priority,
            r.ttft_deadline_t if r.ttft_deadline_t is not None else inf,
            r.arrival_t, r.req_id))
        keep: List[Request] = []
        shed: List[Request] = []
        backlog = view.pending_prefill_s
        for r in order:
            ddl = r.ttft_deadline_t
            est = view.est_prefill_s(r)
            if (ddl is not None and r.first_token_t is None
                    and view.now + backlog + est * self.slack > ddl):
                shed.append(r)
                continue
            keep.append(r)
            if r.needs_prefill:
                backlog += est
        return keep, shed


class StabilityAdmission(AdmissionPolicy):
    """Closed-loop admission driven by a
    :class:`~repro_torch.serving.control.StabilityController`.

    While the controller is **disengaged** (the workload sits inside the
    stability region) the wrapped ``inner`` policy decides verbatim —
    the controller is a provable no-op.  While **engaged**:

      * requests are ordered priority-desc, TTFT-deadline-carriers
        first (deadline-asc), then FIFO;
      * TTFT-unreachable and E2E-unreachable requests are *shed* (the
        E2E check prices the remaining decode at the uncongested
        per-token floor, so only the certainly hopeless are claimed —
        static policies cannot shed a flood of deadline-free-TTFT
        work, this one can);
      * deadline-free requests queued longer than
        ``controller.shed_wait_s()`` are shed — the queue is divergent,
        waiting longer only grows it;
      * survivors are admitted only while the controller's
        regime-dependent row cap (``batch_cap``) and block budget
        (``eff_blocks * (1 - headroom)``) hold; the rest *defer*.

    Not registered in :data:`ADMISSION` — it needs a live controller,
    so the engine wires it when constructed with ``controller=``.
    """

    name = "stability"

    def __init__(self, controller, inner: "AdmissionPolicy | None" = None):
        self.ctrl = controller
        self.inner = inner or AdmissionPolicy()

    def select(self, waiting, view):
        if not self.ctrl.engaged:
            return self.inner.select(waiting, view)
        inf = float("inf")
        order = sorted(waiting, key=lambda r: (
            -r.priority,
            r.ttft_deadline_t if r.ttft_deadline_t is not None else inf,
            r.arrival_t, r.req_id))
        eligible: List[Request] = []
        shed: List[Request] = []
        backlog = view.pending_prefill_s
        rows = max(self.ctrl.batch_cap - view.num_running, 0)
        budget = self.ctrl.block_budget(view) - view.pinned_blocks
        max_wait = self.ctrl.shed_wait_s()
        slack = self.ctrl.cfg.slack
        deferred = 0
        for r in order:
            ttft_ddl = r.ttft_deadline_t
            e2e_ddl = r.e2e_deadline_t
            est = view.est_prefill_s(r) if r.needs_prefill else 0.0
            if (ttft_ddl is not None and r.first_token_t is None
                    and view.now + backlog + est * slack > ttft_ddl):
                shed.append(r)
                continue
            if e2e_ddl is not None:
                rem = max(r.max_new_tokens - len(r.output), 1)
                eta = (view.now + backlog
                       + (est + rem * self.ctrl.tpot_plan(r.slo)) * slack)
                if eta > e2e_ddl:
                    shed.append(r)
                    continue
            if (ttft_ddl is None and e2e_ddl is None
                    and view.now - r.enqueue_t > max_wait):
                shed.append(r)
                continue
            need = view.blocks_needed(r)
            if rows <= 0 or need > budget:
                if not eligible and view.num_running == 0 and rows > 0:
                    eligible.append(r)   # starvation guard: never deadlock
                    rows -= 1
                    continue
                deferred += 1            # defer, reconsider next step
                continue
            rows -= 1
            budget -= need
            eligible.append(r)
            if r.needs_prefill:
                backlog += est
        self.ctrl.stats["shed"] += len(shed)
        self.ctrl.stats["deferred"] += deferred
        return eligible, shed


ADMISSION = {
    "all": AdmissionPolicy,
    "headroom": KVHeadroomAdmission,
    "deadline": SLODeadlineAdmission,
}
