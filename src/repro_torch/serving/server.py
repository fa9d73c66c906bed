"""HarvestServer — the request-lifecycle serving front door.

The engine's ``submit(prompt, n) + run(max_steps)`` surface is
step-indexed and single-class; this facade exposes the lifecycle the
paper's dynamic-availability claims are measured under::

    arrival -> admit -> prefill -> decode/stream -> retire

A :class:`ServeRequest` carries its arrival time on the transfer-engine
clock, an SLO class (``latency | throughput | batch``), per-request
``max_new_tokens``/priority/deadlines and an optional streaming token
callback.  :meth:`HarvestServer.submit` returns a :class:`RequestHandle`
tracking the request through the engine; :meth:`HarvestServer.run`
drives a whole :class:`~repro_torch.serving.workload.Workload` to completion
and :meth:`HarvestServer.run_until` advances the clock to an absolute
time (the building block for co-simulation with external event loops).

Construct one via :meth:`repro_torch.core.runtime.HarvestRuntime.server` (or
directly — the engine kwargs pass through)::

    runtime = HarvestRuntime({1: 64 << 20})
    server = runtime.server(cfg, params, scheduler="fair",
                            admission="deadline", mode="async")
    h = server.submit(ServeRequest(prompt, 16, slo="latency",
                                   ttft_slo_s=2e-4))
    stats = server.run(Workload(num_requests=64, rate=2e4))
    print(stats.summary())          # per-class TTFT/TPOT p50/p99, goodput
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.serving.engine import EngineStats, HarvestServingEngine
from repro_torch.serving.scheduler import Request


@dataclass
class ServeRequest:
    """One request as the client describes it (engine-independent)."""
    prompt: List[int]
    max_new_tokens: int = 16
    #: arrival on the transfer-engine clock; None = "now" (immediately
    #: visible, the legacy behaviour)
    arrival_t: Optional[float] = None
    slo: str = "throughput"
    priority: int = 0
    tenant: str = "default"
    ttft_slo_s: Optional[float] = None
    e2e_slo_s: Optional[float] = None
    #: streaming callback, invoked as ``on_token(token_id, request)`` the
    #: simulated instant each token is committed
    on_token: Optional[Callable[[int, Request], None]] = None


class RequestHandle:
    """A live view of one submitted request's lifecycle."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def req_id(self) -> int:
        return self._req.req_id

    @property
    def state(self) -> str:
        return self._req.state

    @property
    def tokens(self) -> List[int]:
        """Tokens decoded so far (live — grows while the server runs)."""
        return list(self._req.output)

    @property
    def finished(self) -> bool:
        return self._req.state in ("done", "rejected")

    @property
    def rejected(self) -> bool:
        return self._req.state == "rejected"

    # lifecycle timestamps (simulated clock; None until reached)
    @property
    def arrival_t(self) -> float:
        return self._req.arrival_t

    @property
    def admit_t(self) -> Optional[float]:
        return self._req.admit_t

    @property
    def first_token_t(self) -> Optional[float]:
        return self._req.first_token_t

    @property
    def finish_t(self) -> Optional[float]:
        return self._req.finish_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self._req.first_token_t is None:
            return None
        return self._req.first_token_t - self._req.arrival_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self._req.finish_t is None:
            return None
        return self._req.finish_t - self._req.arrival_t

    def __repr__(self):
        return (f"RequestHandle(req_id={self.req_id}, state={self.state!r}, "
                f"tokens={len(self._req.output)})")


class HarvestServer:
    """The serving front door over one :class:`HarvestServingEngine`.

    Every engine kwarg passes through (``scheduler``, ``mode``,
    ``prefetch``, ``admission``, pool geometry, …); the server adds the
    clock-driven request lifecycle on top.  ``prefix_cache=True`` (or a
    :class:`~repro_torch.core.prefix_cache.PrefixCacheConfig`) enables the
    harvested prefix cache: retired prompts' KV blocks are published into
    a radix trie over the block store and later requests sharing the
    prefix skip that part of prefill (``stats.summary()`` reports the hit
    rate; per-request savings land in
    ``RequestRecord.cached_prefix_blocks``).  The legacy engine surface
    stays available underneath as ``server.engine`` — goldens and the
    pipeline tests run bit-exact through either door.
    """

    def __init__(self, cfg, params, *, runtime=None, **engine_kwargs):
        self.engine = HarvestServingEngine(cfg, params, runtime=runtime,
                                           **engine_kwargs)
        self.handles: List[RequestHandle] = []

    # ------------------------------------------------------------- clock
    @property
    def now(self) -> float:
        """The engine clock (transfer-engine timeline basis)."""
        return self.engine._now()

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats

    def summary(self) -> str:
        return self.engine.stats.summary()

    # ------------------------------------------------------------ submit
    def submit(self, req: ServeRequest) -> RequestHandle:
        """Register a request; it becomes visible to admission at its
        ``arrival_t``.  Raises ``ValueError`` for empty prompts,
        non-positive ``max_new_tokens``, unknown SLO classes or arrivals
        in the engine's past."""
        r = self.engine.submit_request(
            prompt=req.prompt, max_new_tokens=req.max_new_tokens,
            arrival_t=req.arrival_t, slo=req.slo, priority=req.priority,
            tenant=req.tenant, ttft_slo_s=req.ttft_slo_s,
            e2e_slo_s=req.e2e_slo_s, on_token=req.on_token)
        h = RequestHandle(r)
        self.handles.append(h)
        return h

    def submit_all(self, reqs) -> List[RequestHandle]:
        """Submit a workload (anything with ``generate()``) or an
        iterable of :class:`ServeRequest`."""
        if hasattr(reqs, "generate"):
            reqs = reqs.generate()
        return [self.submit(r) for r in reqs]

    # --------------------------------------------------------------- run
    def run(self, workload=None, max_steps: int = 10_000) -> EngineStats:
        """Drive the engine until every submitted request retires (or
        ``max_steps``).  ``workload`` — a
        :class:`~repro_torch.serving.workload.Workload` or a list of
        :class:`ServeRequest` — is submitted first."""
        if workload is not None:
            self.submit_all(workload)
        return self.engine.run(max_steps=max_steps)

    def run_until(self, t: float, max_steps: int = 100_000) -> EngineStats:
        """Advance the simulated clock to at least absolute time ``t``:
        serve every request that arrives strictly before ``t``, admit
        those stamped exactly ``t``, then idle any remaining gap so the
        clock lands on ``t``.  Work scheduled after ``t`` stays queued
        for the next drive.  Steps are atomic — a request admitted just
        before ``t`` may push the clock past it, in which case the final
        clock is the completion time of that in-flight step
        (``max(t, step end)``), never corrected backwards.

        The admit-at-``t`` boundary: an arrival stamped exactly ``t`` is
        inside this drive's horizon — it lands in the waiting queue with
        ``enqueue_t == t`` (visible to the scheduler, counted by
        ``finalize``), and its compute runs on the next drive.  Earlier
        versions compared ``next_arrival >= t`` and broke one event
        short, idling straight over a trace-replay arrival that landed
        on the horizon."""
        eng = self.engine
        for _ in range(max_steps):
            eng._admit_arrivals()
            if eng._now() >= t:
                break
            # _pf_jobs: disaggregated prefill streams in flight keep the
            # drive alive even when nothing is waiting or running — the
            # engine's idle branch advances to the next stream-ready
            # event and adopts the finished KV.
            if eng.waiting or eng.running or eng._pf_jobs:
                if not eng.step():
                    break
            else:
                nxt = eng.next_arrival_t()
                if nxt is None or nxt > t:
                    break
                eng._idle_until(nxt)
        if eng._now() < t:
            eng._idle_until(t)
        eng._admit_arrivals()
        return eng.finalize()
