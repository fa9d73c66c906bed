"""Request schedulers for the serving engine.

FCFS continuous batching is the baseline; CompletelyFairScheduler adds
token-level preemption (paper §6.3): fairness increases KV working-set
churn, which Harvest absorbs by lowering the marginal cost of
preemption-induced reloads.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, List, Optional

#: request service classes: ``latency`` requests carry tight TTFT/ITL
#: targets and may jump the queue under an SLO-aware admission policy,
#: ``throughput`` is the default best-effort class, ``batch`` requests are
#: deadline-free background fill.
SLO_CLASSES = ("latency", "throughput", "batch")


@dataclass(eq=False, slots=True)
class Request:
    """One inference request.

    ``eq=False``: requests are mutable scheduler state with identity
    semantics.  The generated field-based ``__eq__`` made membership
    checks (``req in admissible``) compare prompts and outputs, which can
    alias two distinct requests with identical contents; identity (and the
    default ``object`` hash) is the correct notion everywhere the engine
    and schedulers use containment.  ``slots=True``: a million-request
    sweep holds every request live at once, and the per-instance dict is
    both the dominant footprint and a measurable attribute-access cost in
    the step loop.

    Lifecycle timestamps are on the engine's simulated clock (the
    transfer-engine timeline; sync mode derives them from the step
    clock), NOT step indices — ``enqueue_step`` remains the step counter
    for schedulers that reason in steps, the ``*_t`` fields are the time
    record the latency/SLO stats are computed from::

        arrival_t -> [queue] -> admit_t -> first_token_t -> finish_t
    """
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    row: Optional[int] = None          # batch row while running
    state: str = "waiting"             # waiting | running | preempted
    #                                  # | done | rejected
    enqueue_step: int = 0              # scheduler step index at enqueue
    decode_steps: int = 0
    needs_prefill: bool = True         # (re)prefill required (new / rolled back)
    prefill_pos: int = 0               # tokens already prefilled (chunked
    #                                  # prefill resumes from here; a rollback
    #                                  # re-prefill resets it to 0)
    cached_prefix_blocks: int = 0      # prompt blocks served by the prefix
    #                                  # cache at the last (re)prefill
    # ---- request-lifecycle API (SLO class, arrival clock, streaming) ----
    arrival_t: float = 0.0             # clock time the request becomes visible
    slo: str = "throughput"            # latency | throughput | batch
    priority: int = 0                  # higher = sooner under SLO admission
    tenant: str = "default"
    ttft_slo_s: Optional[float] = None  # TTFT target, relative to arrival
    e2e_slo_s: Optional[float] = None   # end-to-end target, rel. to arrival
    on_token: Optional[Callable[[int, "Request"], None]] = None
    # ---- clock timestamps (simulated seconds, engine clock) -------------
    enqueue_t: float = 0.0             # joined the waiting queue
    admit_t: Optional[float] = None    # FIRST admission (preemption-stable)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preempt_count: int = 0

    @property
    def pos(self) -> int:
        return len(self.prompt) + len(self.output) - 1

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    @property
    def ttft_deadline_t(self) -> Optional[float]:
        """Absolute clock deadline for the first token (None = no SLO)."""
        if self.ttft_slo_s is None:
            return None
        return self.arrival_t + self.ttft_slo_s

    @property
    def e2e_deadline_t(self) -> Optional[float]:
        if self.e2e_slo_s is None:
            return None
        return self.arrival_t + self.e2e_slo_s


class FCFSScheduler:
    """Admit in arrival order whenever a batch row frees up."""

    preemptive = False

    def admit(self, waiting: List[Request], free_rows: List[int]
              ) -> List[Request]:
        admitted = []
        while waiting and free_rows:
            r = waiting.pop(0)
            r.row = free_rows.pop(0)
            r.state = "running"
            admitted.append(r)
        return admitted

    def pick_preemption(self, running: List[Request], waiting: List[Request],
                        step: int) -> Optional[Request]:
        return None


class CompletelyFairScheduler(FCFSScheduler):
    """Round-robin over requests at token granularity.

    Every ``quantum`` decode steps, if anyone is waiting, the running request
    with the most decoded tokens is preempted (its KV blocks pushed to the
    Harvest tiers) and the head-of-line waiter takes the row.
    """

    preemptive = True

    def __init__(self, quantum: int = 8):
        if quantum <= 0:
            raise ValueError(
                f"quantum must be a positive number of decode steps, "
                f"got {quantum}")
        self.quantum = quantum

    def pick_preemption(self, running, waiting, step):
        if not waiting or step % self.quantum:
            return None
        candidates = [r for r in running if r.decode_steps >= self.quantum]
        if not candidates:
            return None
        return max(candidates, key=lambda r: r.decode_steps)


SCHEDULERS = {"fcfs": FCFSScheduler, "fair": CompletelyFairScheduler}
