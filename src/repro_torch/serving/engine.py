"""Harvest serving engine: continuous batching + tiered paged KV.

Runs a model for real on ``device`` (a CUDA card unless the caller asks
for the CPU) while the Harvest runtime manages placement: the local pool
is a live f32 tensor on the device, consumed by ``serve_step`` and
updated in place (the JAX engine rebuilds it with ``.at[].set``);
evicted blocks' payloads move into the KVOffloadManager's store (peer /
host tier) through the gather kernel (K6), reloads copy them back through
the fused copy kernel (K5), revocations drop or fall back per
the durability mode, and the cluster-trace monitor injects the external
memory pressure that drives revocations.

Wall time of the host running the model is not the paper's claim, so the
engine keeps a *simulated clock* driven by the runtime's
:class:`~repro_torch.core.store.TransferEngine` (the H100/NVLink or TPU
cost model of :mod:`repro_torch.core.tiers`, not a measurement of the
card). Each iteration runs the same staged pipeline::

    _preempt -> _admit -> _plan_fetches -> _launch_transfers
            -> [prefetch window] -> _compute -> _commit_and_sample -> _retire

and the two clock modes differ only in how the stages charge time:

  * ``mode="sync"`` (default, seed-equivalent): transfers are pre-summed
    with the legacy ``TransferEngine.schedule`` and one decode step costs
    ``overlap(t_compute, t_reload)`` — the original single-``max``
    approximation.
  * ``mode="async"``: transfers are ``submit``-ted onto the event-driven
    timeline (per-direction FIFO link lanes), the step's compute window
    advances the clock, and the step then waits ONLY on the transfers
    whose blocks it actually reads.  Eviction write-backs ride the
    outbound lanes without blocking compute, and a :class:`Prefetcher`
    fills idle inbound-lane time with next-step reloads.

Timing diagram for one async decode step (peer_in carries reloads,
peer_out carries eviction write-backs; ``c`` = compute window)::

    clock      t0                            t0+c      t_end
    compute    |========= decode ============|
    peer_in    |--resume reload r1--|--prefetch r2-->  (r2 ready before
    peer_out   |--preempt writeback----|                next step reads it)
    step       |<------------- max(compute, reads-ready) ------------->|

Generated tokens are REAL (greedy/temperature over the model's logits)
and identical across modes: the pipeline changes *when* bytes move, never
*where* a read is served from.

Continuous batching (async mode): the engine schedules at *iteration*
granularity, not batch granularity.  ``_retire`` frees a batch row and a
same-step refill pass re-admits into it immediately, so a row never
idles across a step boundary while work is queued (``q.batch.occupancy``
in the transfer metrics proves it).  Long prompts prefill in resumable
chunks of ``chunk_prefill_tokens`` interleaved with decode steps — the
chunk rides the decode pass's weight read, so its marginal cost is its
flops and latency-class decodes are never stalled behind a whole
prompt.  A ``SpecDecodeConfig`` seam charges speculative draft/verify
windows on the same clock without changing emitted tokens.

Accounting identity (asserted by ``EngineStats.check_clock_identity``)::

    clock_s == prefill_s + compute_s + (reload_s - writeback_s)
               - hidden_s + idle_s + bubble_s

``reload_s`` is every simulated transfer second; ``writeback_s`` the
subset charged off the critical path (eviction write-outs); ``hidden_s``
the critical-path transfer seconds absorbed under compute windows;
``idle_s`` the request-free gaps a clock-driven arrival process leaves
between bursts; ``bubble_s`` the windows the batch sat empty while work
was queued but not admissible (capacity or policy holds).

Request lifecycle (the front door — :mod:`repro_torch.serving.server`
wraps this engine in the :class:`HarvestServer` facade)::

    arrival_t -> [queue] -> admit -> prefill -> decode/stream -> retire

Requests become visible at ``arrival_t`` on the engine clock (legacy
``submit`` arrives *now*, which keeps the seed goldens bit-exact), an
:class:`~repro_torch.serving.admission.AdmissionPolicy` gates the queue in
front of the FCFS/CFS schedulers, and every retired request leaves a
:class:`RequestRecord` (queue wait, TTFT, TPOT/ITL, end-to-end latency,
SLO attainment) aggregated by ``EngineStats.summary()``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import HarvestAllocator
from repro_torch.core.monitor import PeerMonitor
from repro_torch.core.policy import FIDELITY_POLICIES, FidelityPolicy
from repro_torch.core.prefetch import Prefetcher, PrefetchConfig
from repro_torch.core.prefix_cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.runtime import HarvestRuntime
from repro_torch.core.store import Residency, Transfer
from repro_torch.core.tiers import H100_NVLINK, Fidelity, HardwareModel, Tier
from repro_torch.device import resolve_device
from repro_torch.kernels.harvest_copy.ops import (copy_blocks,
                                                  dequantize_blocks,
                                                  gather_blocks,
                                                  quantize_blocks)
from repro_torch.models import model as M
from repro_torch.serving.admission import (ADMISSION, AdmissionPolicy,
                                     AdmissionView, StabilityAdmission)
from repro_torch.serving.control import ControllerConfig, StabilityController
from repro_torch.serving.scheduler import SCHEDULERS, SLO_CLASSES, Request


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def _host(logits: torch.Tensor) -> np.ndarray:
    """Logits to the host for sampling.  The widening to f32 is exact, so
    argmax and the temperature path see the same values as the JAX
    engine's bf16 numpy array."""
    return logits.float().cpu().numpy()


@dataclass
class RequestRecord:
    """The per-request lifecycle record retired into ``EngineStats``.

    All timestamps are simulated-clock seconds (sync mode derives them
    from the step clock).  ``state`` is ``done`` for served requests and
    ``rejected`` for admission-shed ones (those have no token
    timestamps and count against SLO attainment, not goodput).
    """
    req_id: int
    slo: str
    tenant: str
    state: str
    arrival_t: float
    enqueue_t: float
    admit_t: Optional[float]
    first_token_t: Optional[float]
    finish_t: Optional[float]
    prompt_tokens: int
    output_tokens: int
    preemptions: int
    ttft_slo_s: Optional[float] = None
    e2e_slo_s: Optional[float] = None
    #: prompt blocks served from the prefix cache instead of prefilled
    cached_prefix_blocks: int = 0

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Arrival -> FIRST admission (preemption re-admissions excluded)."""
        if self.admit_t is None:
            return None
        return self.admit_t - self.arrival_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.arrival_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (a.k.a. ITL)."""
        if self.first_token_t is None or self.finish_t is None:
            return None
        return ((self.finish_t - self.first_token_t)
                / max(self.output_tokens - 1, 1))

    @property
    def slo_ok(self) -> bool:
        """Served AND inside every deadline the request carried."""
        if self.state != "done":
            return False
        if self.ttft_slo_s is not None and (
                self.ttft_s is None or self.ttft_s > self.ttft_slo_s):
            return False
        if self.e2e_slo_s is not None and (
                self.e2e_s is None or self.e2e_s > self.e2e_slo_s):
            return False
        return True


@dataclass(frozen=True)
class SpecDecodeConfig:
    """Speculative-decoding *cost seam*: a scenario knob that charges
    draft + verify windows on the transfer-engine clock without changing
    which tokens the engine emits.

    Per accepted token the simulated decode window becomes::

        (draft_tokens * draft_cost_frac * base + verify) / E[accepted]

    where ``base`` is the plain decode window, ``verify`` is one batched
    forward over ``draft_tokens + 1`` positions per row, and
    ``E[accepted] = 1 + a1 + a1*a2 + ...`` over the per-position
    ``accept_rate`` schedule (the verify pass always lands one token —
    greedy spec-decode semantics).  Emitted tokens stay bit-identical:
    the seam models *when* tokens land, a real draft model plugs in
    later with a calibrated slot already wired through stats, serve
    flags and the fig12 benchmark.
    """

    draft_tokens: int = 4
    #: acceptance probability per draft position: one float (flat
    #: schedule) or a tuple of length ``draft_tokens``
    accept_rate: Union[float, Tuple[float, ...]] = 0.7
    #: draft-model cost as a fraction of the target decode window
    draft_cost_frac: float = 0.1

    def __post_init__(self):
        if self.draft_tokens <= 0:
            raise ValueError(
                f"draft_tokens must be positive, got {self.draft_tokens}")
        if not isinstance(self.accept_rate, (int, float)):
            if len(self.accept_rate) != self.draft_tokens:
                raise ValueError(
                    f"accept_rate schedule has {len(self.accept_rate)} "
                    f"entries for {self.draft_tokens} draft positions")
        if any(not 0.0 <= a <= 1.0 for a in self.schedule()):
            raise ValueError(
                f"accept_rate entries must be in [0, 1], got "
                f"{self.accept_rate!r}")
        if not 0.0 < self.draft_cost_frac <= 1.0:
            raise ValueError(
                f"draft_cost_frac must be in (0, 1], got "
                f"{self.draft_cost_frac}")

    def schedule(self) -> Tuple[float, ...]:
        if isinstance(self.accept_rate, (int, float)):
            return (float(self.accept_rate),) * self.draft_tokens
        return tuple(float(a) for a in self.accept_rate)

    def expected_accepted(self) -> float:
        """Expected tokens landed per verify pass (always >= 1)."""
        e, p = 1.0, 1.0
        for a in self.schedule():
            p *= a
            e += p
        return e


def check_servable(cfg: ModelConfig) -> None:
    """The families the engine serves: every family of the model but
    audio.  The JAX package's engine prefills a (1, n) row of prompt
    tokens (``repro/serving/engine.py:953-956``) where the audio family's
    ``embed`` takes (b, s, ncb) codebook tokens, so it cannot serve
    MusicGen, and the port serves no more than its reference."""
    M.check_family(cfg)
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the serving engine takes one token stream, and the "
            f"audio family's model takes (b, s, ncb) codebook tokens; the "
            f"reference engine passes (1, n) prompt tokens "
            f"(repro/serving/engine.py:953-956), so neither serves it (the "
            f"model entry points do)")


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 on an empty sample (guarded)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(int(round(q / 100.0 * (len(s) - 1))), len(s) - 1)]


@dataclass
class EngineStats:
    clock_s: float = 0.0      # simulated wall time
    compute_s: float = 0.0    # decode compute windows
    prefill_s: float = 0.0    # prefill compute windows
    reload_s: float = 0.0     # ALL simulated transfer seconds
    writeback_s: float = 0.0  # subset of reload_s off the critical path
    hidden_s: float = 0.0     # critical transfer seconds hidden under compute
    stall_s: float = 0.0      # async: time the step waited on its reads
    idle_s: float = 0.0       # request-free gaps between clocked arrivals
    bubble_s: float = 0.0     # batch empty while work queued (not admissible)
    steps: int = 0
    tokens_out: int = 0
    recomputes: int = 0
    preemptions: int = 0
    rejected: int = 0         # admission-shed requests
    #: per-request lifecycle records, appended at retire/shed
    requests: List[RequestRecord] = field(default_factory=list)
    #: unified MetricsRegistry snapshot (transfer queues, kv, prefetch, …),
    #: populated by ``HarvestServingEngine.run``
    metrics: Dict[str, dict] = field(default_factory=dict)

    def throughput(self) -> float:
        """Simulated tokens/s; 0.0 for zero-token or zero-clock runs (an
        empty run must report nothing, not tokens/epsilon)."""
        if self.tokens_out <= 0 or self.clock_s <= 0:
            return 0.0
        return self.tokens_out / self.clock_s

    # ------------------------------------------------- request aggregation
    def records(self, slo: Optional[str] = None,
                tenant: Optional[str] = None) -> List[RequestRecord]:
        return [r for r in self.requests
                if (slo is None or r.slo == slo)
                and (tenant is None or r.tenant == tenant)]

    def latency_percentiles(self, slo: Optional[str] = None
                            ) -> Dict[str, float]:
        """p50/p99 of TTFT, TPOT (ITL), queue wait and end-to-end latency
        over the retired records (optionally one SLO class).

        All-shed runs (a stability controller under overload may reject
        every request) yield zero percentiles over an empty sample, never
        a division error — the summary must stay printable."""
        recs = [r for r in self.records(slo) if r.state == "done"]
        if not recs:
            zeros = {"n": 0.0}
            for name in ("ttft", "tpot", "queue_wait", "e2e"):
                zeros[f"{name}_p50"] = zeros[f"{name}_p99"] = 0.0
            return zeros
        out: Dict[str, float] = {"n": float(len(recs))}
        for name, get in (("ttft", lambda r: r.ttft_s),
                          ("tpot", lambda r: r.tpot_s),
                          ("queue_wait", lambda r: r.queue_wait_s),
                          ("e2e", lambda r: r.e2e_s)):
            xs = [v for r in recs if (v := get(r)) is not None]
            out[f"{name}_p50"] = _pct(xs, 50)
            out[f"{name}_p99"] = _pct(xs, 99)
        return out

    def slo_attainment(self, slo: Optional[str] = None) -> float:
        """Fraction of requests (served + shed) that met their SLO."""
        recs = self.records(slo)
        if not recs:
            return 0.0
        return sum(1 for r in recs if r.slo_ok) / len(recs)

    def goodput(self, slo: Optional[str] = None) -> float:
        """SLO-goodput: output tokens of requests that met every deadline
        they carried, per simulated second.  Guarded like
        :meth:`throughput` — zero-clock runs report 0.0."""
        if self.clock_s <= 0:
            return 0.0
        good = sum(r.output_tokens for r in self.records(slo) if r.slo_ok)
        return good / self.clock_s

    @property
    def critical_reload_s(self) -> float:
        """Transfer seconds that were on some step's critical path."""
        return self.reload_s - self.writeback_s

    def check_clock_identity(self, rel: float = 1e-6,
                             abs_tol: float = 1e-12) -> bool:
        """The engine's clock identity: every simulated second is accounted
        exactly once.  (The pre-refactor engine silently dropped prefill- and
        preemption-time eviction transfers from the clock; they are now the
        explicit ``writeback_s`` class.  Clock-driven arrivals add the
        ``idle_s`` class: request-free gaps the engine slept through.
        Continuous batching adds ``bubble_s``: windows the batch sat empty
        while queued work was not admissible.)"""
        expect = (self.prefill_s + self.compute_s
                  + self.reload_s - self.writeback_s - self.hidden_s
                  + self.idle_s + self.bubble_s)
        if not math.isclose(self.clock_s, expect, rel_tol=rel,
                            abs_tol=abs_tol):
            raise AssertionError(
                f"clock identity broken: clock_s={self.clock_s!r} != "
                f"prefill {self.prefill_s!r} + compute {self.compute_s!r} + "
                f"reload {self.reload_s!r} - writeback {self.writeback_s!r} "
                f"- hidden {self.hidden_s!r} + idle {self.idle_s!r} "
                f"+ bubble {self.bubble_s!r} = {expect!r}")
        return True

    def summary(self) -> str:
        """Human-readable report (replaces the launchers' hand-rolled
        clock/compute/reload printouts) including the unified metrics."""
        ms = 1e3
        lines = [
            f"simulated throughput: {self.throughput():.0f} tok/s "
            f"({self.tokens_out} tokens / {self.steps} steps)",
            f"  clock   {self.clock_s * ms:9.3f} ms   "
            f"compute {self.compute_s * ms:9.3f} ms   "
            f"prefill {self.prefill_s * ms:9.3f} ms",
            f"  reload  {self.reload_s * ms:9.3f} ms   "
            f"writeback {self.writeback_s * ms:7.3f} ms   "
            f"hidden {self.hidden_s * ms:10.3f} ms   "
            f"stall {self.stall_s * ms:8.3f} ms",
            f"  preemptions {self.preemptions}   recomputes {self.recomputes}"
            f"   idle {self.idle_s * ms:.3f} ms   rejected {self.rejected}",
        ]
        occ = self.metrics.get("transfer", {}).get("q.batch.occupancy")
        if occ is not None or self.bubble_s:
            qocc = self.metrics.get("transfer", {}).get("q.batch.q_occupancy")
            lines.append(
                "  batch occupancy "
                + (f"{occ:.1%} mean" if occ is not None else "n/a")
                + (f" ({qocc:.1%} while queued)" if qocc is not None else "")
                + f"   bubble {self.bubble_s * ms:.3f} ms")
        if self.requests:
            classes = [c for c in SLO_CLASSES
                       if any(r.slo == c for r in self.requests)]
            for c in classes:
                pc = self.latency_percentiles(c)
                lines.append(
                    f"  {c:10s} n={len(self.records(c))}  "
                    f"ttft p50/p99 {pc['ttft_p50'] * ms:.3f}/"
                    f"{pc['ttft_p99'] * ms:.3f} ms  "
                    f"tpot p50/p99 {pc['tpot_p50'] * ms:.3f}/"
                    f"{pc['tpot_p99'] * ms:.3f} ms  "
                    f"wait p99 {pc['queue_wait_p99'] * ms:.3f} ms  "
                    f"goodput {self.goodput(c):.0f} tok/s  "
                    f"SLO {self.slo_attainment(c):.0%}")
        dev = self.metrics.get("device")
        if dev:
            ids = sorted({k.split(".", 1)[0] for k in dev},
                         key=lambda d: int(d[3:]))
            parts = []
            for d in ids:
                budget = dev.get(f"{d}.budget", 0)
                occ = dev.get(f"{d}.used", 0) / budget if budget else 0.0
                parts.append(f"{d} occ={occ:.0%} "
                             f"churn={dev.get(f'{d}.churn', 0.0)/2**20:.2f}MiB")
            lines.append("  devices: " + "  ".join(parts))
        pfx = self.metrics.get("prefix")
        if pfx and pfx.get("lookups"):
            lb = pfx.get("lookup_blocks", 0)
            hb = pfx.get("hit_blocks", 0)
            rate = hb / lb if lb else 0.0          # zero-division guarded
            peer = pfx.get("peer_hits", 0) / hb if hb else 0.0
            lines.append(
                f"  prefix: hit rate {rate:.0%} ({hb}/{lb} blocks)  "
                f"saved-from-prefill {hb} blocks  peer-hit {peer:.0%}  "
                f"cow {pfx.get('cow_splits', 0)}  "
                f"evicted {pfx.get('evictions', 0)}  "
                f"cached {pfx.get('nodes', 0)}")
        co = self.metrics.get("coalesce")
        if co and (co.get("batches") or co.get("solo")
                   or co.get("striped_objects")):
            batches = co.get("batches", 0)
            members = co.get("batch_members", 0)
            lines.append(
                f"  coalesce: batches {batches}  members {members}  "
                f"avg batch {members / batches if batches else 0.0:.2f}  "
                f"solo {co.get('solo', 0)}  "
                f"setup saved {co.get('saved_setup_s', 0.0) * ms:.3f} ms")
        xfer = self.metrics.get("transfer", {})
        s_obj = sum(v for k, v in xfer.items()
                    if k.endswith(".stripe_objects"))
        if s_obj:
            s_chk = sum(v for k, v in xfer.items()
                        if k.endswith(".stripe_chunks"))
            ways = max((v for k, v in xfer.items()
                        if k.endswith(".stripe_ways")), default=0)
            util = min(s_chk / s_obj / ways, 1.0) if ways else 0.0
            lines.append(f"  stripe: objects {s_obj}  chunks {s_chk}  "
                         f"ways {ways}  sub-lane utilization {util:.0%}")
        fid = self.metrics.get("fid")
        if fid and (fid.get("demote_quantized") or fid.get("bytes_saved")):
            per_tier = {k[len("demote_"):]: v for k, v in fid.items()
                        if k.startswith("demote_")
                        and k != "demote_quantized" and v}
            resident = sum(v for k, v in fid.items() if ".blocks_" in k)
            share = (fid.get("dequant_s", 0.0) / self.clock_s
                     if self.clock_s else 0.0)   # zero-division guarded
            lines.append(
                "  fidelity: quantized demotes "
                f"{fid.get('demote_quantized', 0)}"
                + ("".join(f"  {n}:{c}" for n, c in sorted(per_tier.items()))
                   if per_tier else "")
                + f"  resident {resident}  "
                f"dequant reloads {fid.get('reload_dequantized', 0)}  "
                f"link bytes saved {fid.get('bytes_saved', 0) / 2**20:.2f}"
                f" MiB  dequant {fid.get('dequant_s', 0.0) * ms:.3f} ms "
                f"({share:.1%} of clock)")
        ctrl = self.metrics.get("ctrl")
        if ctrl and ctrl.get("ticks"):
            lines.append(
                f"  ctrl: rho {ctrl.get('rho', 0.0):.2f} "
                f"(mem {ctrl.get('rho_mem', 0.0):.2f} "
                f"rows {ctrl.get('rho_rows', 0.0):.2f})  "
                f"eff {ctrl.get('eff_blocks', 0.0):.1f} blk  "
                f"{'ENGAGED' if ctrl.get('engaged') else 'idle'}  "
                f"cap {int(ctrl.get('batch_cap', 0))}  "
                f"engages {ctrl.get('engages', 0)}  "
                f"shed {ctrl.get('shed', 0)}  "
                f"deferred {ctrl.get('deferred', 0)}")
        for ns in ("prefetch", "transfer", "spec", "allocator", "monitor"):
            counters = self.metrics.get(ns)
            if not counters:
                continue
            shown = {k: v for k, v in counters.items()
                     if ns != "transfer" or k.startswith("q.")}
            if shown:
                body = "  ".join(f"{k}={v:.4g}" if isinstance(v, float)
                                 else f"{k}={v}" for k, v in shown.items())
                lines.append(f"  {ns}: {body}")
        return "\n".join(lines)


class _PrefillJob:
    """One request's in-flight disaggregated prefill: the pool-worker
    occupancy (``job``), the DCN KV stream (``stream``), and the computed
    payload the decode pool adopts once the stream lands."""
    __slots__ = ("r", "job", "stream", "n", "k", "v", "states", "collected")

    def __init__(self, r: Request, job: Transfer, stream: List[Transfer],
                 n: int, k, v, states):
        self.r = r
        self.job = job
        self.stream = stream
        self.n = n                      # prefix tokens the payload covers
        self.k = k                      # (L, n_pad, nkv, hd) numpy, or None
        self.v = v
        self.states = states            # the prefill's recurrent states
        self.collected = False          # moved back to the waiting queue


class HarvestServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 block_size: int = 16, num_local_slots: int = 24,
                 max_seq_len: int = 256,
                 runtime: Optional[HarvestRuntime] = None,
                 allocator: Optional[HarvestAllocator] = None,
                 monitor: Optional[PeerMonitor] = None,
                 hardware: Optional[HardwareModel] = None,
                 scheduler: str = "fcfs", durability: str = "host_backed",
                 temperature: float = 0.0, seed: int = 0,
                 overlap_reloads: bool = True, mode: str = "sync",
                 prefetch: Optional[PrefetchConfig] = None,
                 admission: "str | AdmissionPolicy" = "all",
                 prefix_cache: "bool | PrefixCacheConfig" = False,
                 chunk_prefill_tokens: Optional[int] = None,
                 spec_decode: Optional[SpecDecodeConfig] = None,
                 iter_refill: Optional[bool] = None,
                 fidelity_policy: "str | FidelityPolicy | None" = None,
                 cold_tier: bool = False,
                 host_capacity_bytes: Optional[int] = None,
                 disaggregated: bool = False,
                 prefill_workers: int = 2,
                 controller: "str | ControllerConfig | StabilityController "
                             "| None" = None,
                 device="cuda"):
        check_servable(cfg)
        self.device = resolve_device(device)
        off = [t.device for t in _leaves(params) if t.device != self.device]
        if off:
            raise ValueError(f"params live on {off[0]}, the engine on "
                             f"{self.device}")
        assert mode in ("sync", "async"), f"unknown clock mode {mode!r}"
        # the engine runs over ONE HarvestRuntime; the allocator/monitor/
        # hardware kwargs are a shorthand that wraps them into a fresh one
        if runtime is None:
            runtime = HarvestRuntime(hardware=hardware or H100_NVLINK,
                                     allocator=allocator, monitor=monitor)
        else:
            assert allocator is None and monitor is None and hardware is None, \
                "pass either runtime= or allocator=/monitor=/hardware=, " \
                "not both"
        self.runtime = runtime
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.bs = block_size
        self.hw = runtime.hardware
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.mode = mode
        self.overlap = overlap_reloads
        self.monitor = runtime.monitor
        self.scheduler = SCHEDULERS[scheduler]() if isinstance(scheduler, str) \
            else scheduler
        self.admission: AdmissionPolicy = (
            ADMISSION[admission]() if isinstance(admission, str) else admission)

        self.L_kv = M.num_kv_layers(cfg)
        nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        self.n_slots = num_local_slots
        self.allocator = runtime.allocator

        # fidelity-tiered demotion: per-SLO-class precision on the demote
        # path (the store's fidelity_fn seam) + an optional SSD cold tier
        # under host DRAM.  ``None``/"off" keeps every demotion FP16 —
        # the seed-exact path, bytes and tokens included.
        if isinstance(fidelity_policy, str):
            if fidelity_policy not in FIDELITY_POLICIES:
                raise ValueError(
                    f"unknown fidelity policy {fidelity_policy!r}; expected "
                    f"one of {sorted(FIDELITY_POLICIES)}")
            fidelity_policy = FIDELITY_POLICIES[fidelity_policy]
        self._fid_policy: Optional[FidelityPolicy] = (
            None if (fidelity_policy is None or fidelity_policy.mode == "off")
            else fidelity_policy)
        assert not cold_tier or mode == "async", \
            "the SSD cold tier needs the event timeline: pass mode='async'"
        #: req_id -> SLO class, resolved by the store's fidelity callback
        self._req_slo: Dict[int, str] = {}

        self.kv_mgr = runtime.kv_manager(
            cfg, block_size=block_size, num_local_slots=num_local_slots,
            durability=durability, store_payload=True,
            num_kv_layers=self.L_kv, ssd_tier=cold_tier,
            host_capacity_bytes=host_capacity_bytes)
        self.kv_mgr.evict_hook = self._on_evict
        self.kv_mgr.reload_hook = self._on_reload
        if self._fid_policy is not None:
            self.kv_mgr.fidelity_fn = self._fidelity_for

        # transfer coalescing/striping: runtimes built with a
        # CoalesceConfig carry a TransferPlanner; like prefetch it needs
        # the event timeline (sync mode is the bit-exact compat path)
        self._planner = runtime.planner
        assert self._planner is None or mode == "async", \
            "transfer coalescing needs the event timeline: pass mode='async'"
        self._step_plan: List = []   # critical transfers buffered per step

        self.prefetcher: Optional[Prefetcher] = None
        if prefetch is not None:
            assert mode == "async", \
                "prefetch needs the event timeline: pass mode='async'"
            self.prefetcher = Prefetcher(
                self.kv_mgr, runtime.transfers, prefetch,
                planner=self._planner, metrics=runtime.metrics)

        # harvested prefix cache: cross-request KV sharing keyed on
        # token-block digests; False (default) keeps every legacy path —
        # and the seed goldens — bit-exact, clock included
        self._pcache: Optional[PrefixCache] = None
        if prefix_cache:
            assert self.L_kv, "prefix cache needs a paged KV cache"
            npre = (cfg.modality.num_prefix_embeddings
                    if cfg.modality else 0)
            assert npre == 0, \
                "prefix cache keys on token blocks only — prefix-embedding " \
                "models cannot be content-addressed by tokens"
            self._pcache = PrefixCache(
                self.kv_mgr,
                prefix_cache if isinstance(prefix_cache, PrefixCacheConfig)
                else None,
                metrics=runtime.metrics)
        self.prefix_cache = self._pcache

        if self.L_kv:
            self.pool_k = torch.zeros((self.L_kv, self.n_slots, block_size,
                                       nkv, hd), dtype=torch.float32,
                                      device=self.device)
            self.pool_v = torch.zeros_like(self.pool_k)
            # row l * n_slots + slot of a pool's (L_kv * n_slots, block)
            # view is layer l of that slot: one mover launch per pool
            # covers every layer
            self._layer_rows = np.arange(self.L_kv, dtype=np.int32) \
                * self.n_slots
            # the one-row id of _degrade's flat payload on the device (for
            # K3), and its host mirror (the checks; K2 takes it in the
            # launch)
            self._row0 = torch.zeros((1,), dtype=torch.int32,
                                     device=self.device)
            self._row0_host = np.zeros((1,), np.int32)
        else:
            self.pool_k = self.pool_v = None
        self.states = M.init_states(cfg, self.B, self.device)
        self.slot_req = np.full((self.n_slots,), -1, np.int32)
        self.slot_base = np.zeros((self.n_slots,), np.int32)

        self.row_tokens = np.zeros((self.B,), np.int32)
        self.row_pos = np.zeros((self.B,), np.int32)
        self.free_rows = list(range(self.B))
        self.row_of: Dict[int, int] = {}       # req_id -> batch row
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        #: clock-ordered future arrivals: (arrival_t, req_id, Request)
        #: heap; requests move to ``waiting`` once the clock reaches them
        self._arrivals: List[Tuple[float, int, Request]] = []
        self.stats = EngineStats()
        self._next_id = 0
        self._decode_fn = lambda p, st: M.serve_step(p, st, cfg)
        self._prefill_fn = lambda p, batch: M.forward(p, batch, cfg,
                                                      want_kv=True)

        # per-token decode compute estimate (weight-read bound)
        pc = cfg.param_counts()
        self._t_flop_tok = 2 * pc["active"] / self.hw.peak_flops
        self._t_weights = 2 * pc["active"] / self.hw.hbm_bw

        # closed-loop stability controller: estimates load online,
        # computes the stability region, and actuates admission / batch
        # cap / prefetch budgets / harvest appetite while engaged.  None
        # (or "off") keeps every path — tokens AND clock — bit-exact;
        # even when enabled it only diverges once the workload leaves the
        # stability region (the no-op property the tests pin).
        if controller == "off":
            controller = None
        elif controller == "stability":
            controller = StabilityController()
        elif isinstance(controller, ControllerConfig):
            controller = StabilityController(controller)
        elif isinstance(controller, str):
            raise ValueError(f"unknown controller {controller!r}; expected "
                             f"'off' or 'stability'")
        self._controller: Optional[StabilityController] = controller
        if self._controller is not None:
            assert mode == "async", \
                "the stability controller ticks on the event timeline: " \
                "pass mode='async'"
            self._controller.attach(self)
            self.admission = StabilityAdmission(self._controller,
                                                inner=self.admission)
        self.controller = self._controller

        # timeline-driven pressure: when the monitor carries a tick
        # interval AND the engine runs on the event clock, trace ticks fire
        # on the simulated timeline (mid-pipeline) instead of every 4th
        # scheduler step; counts fired ticks, None = legacy stepwise drive
        self._timeline_ticks: Optional[int] = (
            0 if (mode == "async" and self.monitor is not None
                  and getattr(self.monitor, "tick_interval_s", None)
                  is not None)
            else None)
        # async-mode clock base: the engine may share a timeline that has
        # already advanced (another engine / simulator on the same runtime)
        self._clock0 = runtime.transfers.now
        # transfers the CURRENT step's reads block on, + their seconds
        self._step_waits: List = []
        self._step_critical_s = 0.0
        self._append_slot = np.full((self.B,), self.n_slots, np.int32)
        self._append_off = np.zeros((self.B,), np.int32)

        # -------- continuous batching (iteration-level scheduling) --------
        if chunk_prefill_tokens is not None and chunk_prefill_tokens <= 0:
            raise ValueError(f"chunk_prefill_tokens must be positive, got "
                             f"{chunk_prefill_tokens}")
        assert chunk_prefill_tokens is None or mode == "async", \
            "chunked prefill interleaves with the event timeline: " \
            "pass mode='async'"
        self._chunk_tokens = chunk_prefill_tokens
        #: prefills finished THIS step (first token pending commit stamp)
        self._chunk_done: List[Request] = []
        # iteration-level slot refill: retired rows refill in the same
        # step.  Default on for the event timeline; sync stays the
        # bit-exact legacy batch-granularity path.
        if iter_refill is None:
            iter_refill = mode == "async"
        assert not (iter_refill and mode == "sync"), \
            "per-iteration slot refill needs mode='async' (sync is the " \
            "bit-exact legacy path)"
        self._refill = iter_refill
        self._spec = spec_decode
        self._spec_stats = (runtime.metrics.counters("spec")
                            if spec_decode is not None else None)
        # time-weighted batch-row occupancy over step/bubble windows
        # (q.batch.* in the transfer namespace; q_* = queue non-empty)
        self._qbatch = (runtime.metrics.counters("transfer")
                        if mode == "async" else None)

        # -------- disaggregated prefill/decode (scale-out) ----------------
        # Fresh prefills run on a dedicated pool of ``prefill_workers``
        # accelerators on a REMOTE host; finished KV blocks stream over the
        # topology's DCN lanes and the decode pool adopts them like a
        # prefix-cache hit (zero prefill compute on the decode accelerator,
        # the stream tail attached to the adopting step's wait set).
        # Tokens are bit-identical to the colocated path: the same single
        # full-prefix forward produces them either way.
        self._disagg = bool(disaggregated)
        if self._disagg:
            assert mode == "async", \
                "disaggregated prefill/decode needs the event timeline: " \
                "pass mode='async'"
            assert self._pcache is None, \
                "disaggregated mode and the prefix cache are separate " \
                "adoption paths — enable one at a time"
            assert self.L_kv, \
                "disaggregated prefill streams KV blocks: needs a paged " \
                "KV cache"
            topo = runtime.topology
            assert topo is not None and len(topo.hosts) > 1, \
                "disaggregated mode streams KV over DCN — attach a " \
                "multi-host topology (e.g. get_topology('h100-dcn-2host'))"
            if prefill_workers <= 0:
                raise ValueError(f"prefill_workers must be positive, got "
                                 f"{prefill_workers}")
            # the prefill pool lives on the remote hosts: each request's KV
            # stream rides one remote device's dcn{h}_in lane, round-robin
            # over hosts so multi-host presets stream in parallel
            self._stream_devices = [topo.devices_on(h)[0]
                                    for h in topo.hosts if h != 0]
        self._pf_workers = prefill_workers
        self._pf_jobs: Dict[int, _PrefillJob] = {}
        self._prefilling: List[Request] = []

    # ----------------------------------------------------------- fidelity
    def _fidelity_for(self, key) -> Fidelity:
        """Store callback: the precision the block being evicted demotes
        at.  Shared prefix-trie content blocks (``("px", ...)`` keys) have
        no owning request and take the policy's ``shared`` fidelity;
        everything else resolves owner -> SLO class -> policy."""
        shared = bool(key) and isinstance(key, tuple) and key[0] == "px"
        slo = None if shared else self._req_slo.get(key[0])
        return self._fid_policy.fidelity_for(slo, shared=shared)

    def _degrade(self, data: torch.Tensor, fid: Fidelity) -> torch.Tensor:
        """Round-trip one evicted block's payload through the
        quantize_demote / dequantize_reload kernels on the device, so the
        stored copy is numerically what the wire carries: a later reload
        reads back exactly the dequantized values and quantized-class
        decodes genuinely run on reduced-precision KV."""
        flat = data.reshape(1, -1).float().contiguous()
        ids, host = self._row0, self._row0_host
        values, scales = quantize_blocks(flat, ids, fidelity=fid.value,
                                         host_ids=host)
        # K3 writes every element of its destination rows, and the one row
        # here is the whole tensor: nothing of empty_like's bytes survives
        deg = dequantize_blocks(torch.empty_like(flat), values, scales, ids,
                                fidelity=fid.value, host_ids=host)
        return deg.reshape(data.shape).to(data.dtype)

    # ----------------------------------------------------------- payload
    def _rows(self, pool):
        """``pool`` as the (L_kv * n_slots, block elements) rows the block
        movers take (a view: writes land in the pool)."""
        return pool.view(self.L_kv * self.n_slots, -1)

    def _copy_slot(self, k_src, v_src, slot) -> None:
        """Write every layer's k and v of pool ``slot`` with the fused copy
        kernel (K5); ``k_src``/``v_src`` are (source rows, row ids), the
        ids in layer order."""
        dst = self._layer_rows + slot
        for pool, (rows, ids) in ((self.pool_k, k_src),
                                  (self.pool_v, v_src)):
            copy_blocks(rows, self._rows(pool), ids, dst)

    def _evict_payload(self, slot, fid: Optional[Fidelity]) -> np.ndarray:
        """Every layer's k and v of pool ``slot`` as the host payload
        (L_kv, 2, bs, nkv, hd), round-tripped through ``fid``'s wire
        format when it is quantized."""
        # K6 gathers k and v straight into the two halves of one contiguous
        # (L_kv, 2, ...) payload, the row ids riding in its launch: no id
        # copy, no transpose, no copy behind .cpu() or _degrade's reshape
        data = self.pool_k.new_empty((self.L_kv, 2) + self.pool_k.shape[2:])
        ids = self._layer_rows + slot
        for h, p in enumerate((self.pool_k, self.pool_v)):
            gather_blocks(self._rows(p), ids,
                          out=data[:, h].view(self.L_kv, -1))
        if fid is not None and fid.is_quantized:
            data = self._degrade(data, fid)
        return data.cpu().numpy()

    def _on_evict(self, bid, slot):
        if self.prefetcher is not None:
            self.prefetcher.on_evict(bid)
        if self.pool_k is None:
            return
        ent = self.kv_mgr.table.get(bid)
        self.kv_mgr.write_payload(*bid, self._evict_payload(
            slot, ent.fidelity if ent is not None else None))
        self.slot_req[slot] = -1

    def _on_reload(self, bid, slot):
        data = self.kv_mgr.read_payload(*bid)
        assert data is not None, f"reload of lost block {bid}"
        # the payload lands in a staging pool on the device whose rows
        # alternate k and v layer by layer; K5 moves them into the slot
        staging = torch.from_numpy(np.ascontiguousarray(data)).to(
            self.device, self.pool_k.dtype).view(2 * self.L_kv, -1)
        k_ids = 2 * np.arange(self.L_kv, dtype=np.int32)
        self._copy_slot((staging, k_ids), (staging, k_ids + 1), slot)
        self.slot_req[slot] = self.row_of.get(bid[0], -1)
        self.slot_base[slot] = self.kv_mgr.table[bid].base_pos

    # ------------------------------------------------------------ states
    def _set_state_row(self, row, new_states):
        """Write one request's prefill states into its batch row, in the
        batch states' dtypes (``.at[].set`` casts as this does)."""
        if self.cfg.family == "hybrid":
            pairs = [(self.states, new_states, 1)]
        else:
            pairs = [(self.states[0], new_states[0], 2),
                     (self.states[1], new_states[1], 1)]
        for full, one, lead in pairs:
            for f, o in zip(full, one):
                f[(slice(None),) * lead + (row,)] = o[(slice(None),) * lead
                                                      + (0,)]

    # ------------------------------------------------------------ submit
    def _now(self) -> float:
        """The engine clock (same basis as ``stats.clock_s``): the step
        clock in sync mode, the transfer timeline in async mode."""
        if self.mode == "sync":
            return self.stats.clock_s
        return self.runtime.transfers.now - self._clock0

    def submit(self, prompt: List[int], max_new_tokens: int) -> Request:
        """Legacy compat wrapper: the request arrives *now* (before
        ``run`` that is clock 0, which keeps the seed goldens bit-exact).
        The lifecycle API is :meth:`submit_request` / ``HarvestServer``."""
        return self.submit_request(prompt=prompt,
                                   max_new_tokens=max_new_tokens)

    def submit_request(self, *, prompt: List[int], max_new_tokens: int,
                       arrival_t: Optional[float] = None,
                       slo: str = "throughput", priority: int = 0,
                       tenant: str = "default",
                       ttft_slo_s: Optional[float] = None,
                       e2e_slo_s: Optional[float] = None,
                       on_token=None) -> Request:
        """Request-lifecycle entry point: the request becomes visible to
        admission at ``arrival_t`` on the engine clock (default: now)."""
        if not prompt:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got "
                             f"{max_new_tokens}")
        if slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo!r}; expected one of "
                             f"{SLO_CLASSES}")
        now = self._now()
        if arrival_t is None:
            arrival_t = now
        if arrival_t < now:
            raise ValueError(f"arrival_t={arrival_t} is in the engine's "
                             f"past (clock is at {now})")
        r = Request(self._next_id, list(prompt), max_new_tokens,
                    arrival_t=arrival_t, slo=slo, priority=priority,
                    tenant=tenant, ttft_slo_s=ttft_slo_s,
                    e2e_slo_s=e2e_slo_s, on_token=on_token,
                    enqueue_t=arrival_t, enqueue_step=self.stats.steps)
        self._next_id += 1
        self._req_slo[r.req_id] = slo
        if arrival_t <= now:
            self.waiting.append(r)
            if self._controller is not None:
                self._controller.on_arrival(r)
        else:
            heapq.heappush(self._arrivals, (arrival_t, r.req_id, r))
        return r

    def next_arrival_t(self) -> Optional[float]:
        """Clock time of the earliest not-yet-visible request."""
        return self._arrivals[0][0] if self._arrivals else None

    def _admit_arrivals(self) -> int:
        """Move every request whose ``arrival_t`` the clock has reached
        into the waiting queue (arrival order)."""
        now = self._now()
        n = 0
        while self._arrivals and self._arrivals[0][0] <= now + 1e-15:
            _, _, r = heapq.heappop(self._arrivals)
            self.waiting.append(r)
            if self._controller is not None:
                self._controller.on_arrival(r)
            n += 1
        return n

    def _idle_until(self, t: float) -> None:
        """Advance the clock through a request-free gap to the next
        arrival.  Idle seconds are their own accounting class — the
        clock identity stays exact under bursty workloads."""
        dt = t - self._now()
        if dt <= 0:
            return
        self.stats.idle_s += dt
        if self.mode == "sync":
            self.stats.clock_s += dt
        else:
            self.runtime.transfers.drain_until(self._clock0 + t)
            self._sync_clock()

    # ------------------------------------------------------------ prefill
    def _adopt_prefix(self, r: Request) -> List[Tuple[int, tuple]]:
        """Prefix-cache lookup for a (re)prefill: lease each matched
        content block zero-copy, or COW-split it when another live request
        already holds the lease (the decode kernel maps each pool slot to
        exactly one batch row).  The matched chain's only clock cost is
        its reloads — charged critical, exactly like a resume."""
        matched = self._pcache.match(r.prompt + r.output)
        t = 0.0
        for j, ckey in matched:
            st = self.kv_mgr.store.table[ckey].state
            tier = ("local_hits" if st is Residency.LOCAL else
                    "peer_hits" if st is Residency.PEER else "host_hits")
            self._pcache.stats[tier] += 1
            if self.kv_mgr.lessee_of(ckey) is not None:
                slot, reload_ops, alloc_ops = self.kv_mgr.cow_split(
                    r.req_id, j, ckey)
                self._pcache.stats["cow_splits"] += 1
                t += self._charge_critical(reload_ops)
                self._charge_writeback(alloc_ops)
                src = self.kv_mgr.store.table[ckey].local_slot
                ids = self._layer_rows + src
                self._copy_slot((self._rows(self.pool_k), ids),
                                (self._rows(self.pool_v), ids), slot)
            else:
                t += self._charge_critical(
                    self.kv_mgr.adopt_block(r.req_id, j, ckey))
                slot = self.kv_mgr.store.table[ckey].local_slot
            self.slot_req[slot] = r.row
            self.slot_base[slot] = j * self.bs
        if self.mode == "sync":
            self.stats.clock_s += t
        return matched

    def _prefill_forward(self, prefix: List[int]):
        """One REAL forward over the (padded) prefix; returns
        ``(logits, out, npre, n_pad)``.  Shared by the inline prefill and
        the final chunk of a chunked prefill — token fidelity comes from
        this single full-prefix forward in both paths.  A model with
        ``npre`` prefix embeddings gets zeros for them (the frontend is a
        stub) ahead of the tokens, positions over both, and, with M-RoPE,
        its (t, h, w) ids all equal to the position."""
        n = len(prefix)
        n_pad = self.bs * math.ceil(n / self.bs)
        toks = np.zeros((1, n_pad), np.int32)
        toks[0, :n] = prefix
        npre = self.cfg.modality.num_prefix_embeddings \
            if self.cfg.modality else 0
        s_all = n_pad + npre
        pos = torch.arange(s_all, dtype=torch.int32, device=self.device)
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "positions": pos[None]}
        if npre:
            batch["prefix_embeddings"] = torch.zeros(
                (1, npre, self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if self.cfg.rope_style == "mrope":
            batch["positions_3d"] = pos[None, :, None].expand(1, s_all, 3)
        logits, out = self._prefill_fn(self.params, batch)
        return logits, out, npre, n_pad

    def _prefill(self, r: Request) -> None:
        prefix = r.prompt + r.output            # rollback re-prefills output
        n = len(prefix)
        logits, out, npre, n_pad = self._prefill_forward(prefix)
        row = r.row
        # prefix-cache lookup: adopt (or COW-split) the longest cached
        # block chain BEFORE the prefill window — a hit's only cost is
        # its (possibly peer->local) reload, charged on the critical path
        matched = self._adopt_prefix(r) if self._pcache is not None \
            and self.L_kv else []
        r.cached_prefix_blocks = len(matched)
        # simulated prefill cost: read weights once + compute of the
        # UNMATCHED suffix — prefill starts from the divergence point (the
        # same estimate deadline admission sheds against).  The REAL
        # forward above still spans the whole prefix: the repo's "real
        # compute for token fidelity, simulated clock for cost" pattern.
        prefill_t = self._prefill_window_s(n - len(matched) * self.bs)
        self.stats.prefill_s += prefill_t
        if self.mode == "sync":
            self.stats.clock_s += prefill_t
        else:
            # buffered critical transfers must hit the lanes before the
            # prefill window advances the clock past their plan time
            self._flush_step_plan()
            self.runtime.transfers.advance(prefill_t)
            self._sync_clock()

        if self.L_kv:
            k, v = out.kv
            if npre:   # prefix embeddings occupy the first npre positions
                k, v = k[:, :, npre:], v[:, :, npre:]
            nb = math.ceil(n / self.bs)
            for j in range(len(matched), nb):
                slot, ops = self.kv_mgr.allocate_block(r.req_id, j, j * self.bs)
                self._charge_writeback(ops)
                lo, hi = j * self.bs, min((j + 1) * self.bs, n_pad)
                self.pool_k[:, slot, :hi - lo] = k[:, 0, lo:hi].float()
                self.pool_v[:, slot, :hi - lo] = v[:, 0, lo:hi].float()
                self.slot_req[slot] = row
                self.slot_base[slot] = j * self.bs
                ent = self.kv_mgr.table[(r.req_id, j)]
                ent.filled = min(self.bs, n - lo) if lo < n else 0
        if out.states is not None:
            self._set_state_row(row, out.states)

        nxt = self._sample(_host(logits[0, npre + n - 1]))
        if not r.output:
            r.output.append(int(nxt))
            self.stats.tokens_out += 1
            # TTFT lands here exactly once: a rollback re-prefill replays
            # the prefix without re-emitting (or re-timestamping) a token
            if r.first_token_t is None:
                r.first_token_t = self._now()
            if r.on_token is not None:
                r.on_token(int(nxt), r)
        self.row_tokens[row] = r.output[-1]
        self.row_pos[row] = len(r.prompt) + len(r.output) - 1
        r.needs_prefill = False

    # ---------------------------------------------------- chunked prefill
    def _prefill_chunks(self) -> int:
        """Advance every in-flight prefill by up to ``chunk_prefill_tokens``
        tokens total this step (FIFO over the running set), interleaved
        with the decode pass.  Returns the tokens consumed — the step
        window charges their flops on top of the decode weight read."""
        self._chunk_done = []
        if self._chunk_tokens is None:
            return 0
        budget = self._chunk_tokens
        total = 0
        for r in list(self.running):
            if budget <= 0:
                break
            if not r.needs_prefill:
                continue
            c = self._advance_chunk(r, budget)
            budget -= c
            total += c
            if not r.needs_prefill:
                self._chunk_done.append(r)
        return total

    def _advance_chunk(self, r: Request, budget: int) -> int:
        """One resumable prefill chunk: allocate the chunk's KV blocks
        (ONE coalesced write-back burst per chunk instead of per prompt)
        and advance ``prefill_pos``.  The first chunk adopts the cached
        prefix chain; the last runs the real forward via
        :meth:`_finish_prefill`."""
        prefix = r.prompt + r.output
        n = len(prefix)
        if r.prefill_pos == 0 and self._pcache is not None and self.L_kv:
            # chunking starts from the divergence point, like _prefill
            matched = self._adopt_prefix(r)
            r.cached_prefix_blocks = len(matched)
            r.prefill_pos = min(len(matched) * self.bs, n)
        c = min(budget, n - r.prefill_pos)
        lo = r.prefill_pos
        r.prefill_pos += c
        if self.L_kv and c:
            ops = []
            for j in range(lo // self.bs,
                           math.ceil(r.prefill_pos / self.bs)):
                if (r.req_id, j) in self.kv_mgr.table:
                    continue
                slot, aops = self.kv_mgr.allocate_block(r.req_id, j,
                                                        j * self.bs)
                ops.extend(aops)
                self.slot_req[slot] = r.row
                self.slot_base[slot] = j * self.bs
            if ops:
                self._charge_writeback(ops)
        if r.prefill_pos >= n:
            self._finish_prefill(r)
        return c

    def _finish_prefill(self, r: Request) -> None:
        """The last chunk: run the REAL forward over the whole prefix
        (identical to the unchunked call — chunking changes only the
        clock, never the tokens), fill the pool payloads of every
        non-cached block, and land the first token.  Its timestamp and
        stream callback are deferred to :meth:`_commit_first_tokens` —
        TTFT is the end of the step window the chunk completed in."""
        prefix = r.prompt + r.output
        n = len(prefix)
        logits, out, npre, n_pad = self._prefill_forward(prefix)
        row = r.row
        if self.L_kv:
            k, v = out.kv
            if npre:
                k, v = k[:, :, npre:], v[:, :, npre:]
            nb = math.ceil(n / self.bs)
            for j in range(r.cached_prefix_blocks, nb):
                # blocks were allocated chunk by chunk; fill payloads now
                ent = self.kv_mgr.table[(r.req_id, j)]
                slot = ent.local_slot
                lo, hi = j * self.bs, min((j + 1) * self.bs, n_pad)
                self.pool_k[:, slot, :hi - lo] = k[:, 0, lo:hi].float()
                self.pool_v[:, slot, :hi - lo] = v[:, 0, lo:hi].float()
                self.slot_req[slot] = row
                self.slot_base[slot] = j * self.bs
                ent.filled = min(self.bs, n - lo) if lo < n else 0
        if out.states is not None:
            self._set_state_row(row, out.states)
        nxt = self._sample(_host(logits[0, npre + n - 1]))
        if not r.output:
            # a rollback re-prefill replays the prefix without re-emitting
            r.output.append(int(nxt))
            self.stats.tokens_out += 1
        self.row_tokens[row] = r.output[-1]
        self.row_pos[row] = len(r.prompt) + len(r.output) - 1
        r.needs_prefill = False

    def _commit_first_tokens(self) -> None:
        """Stamp + stream the first tokens of prefills that finished this
        step, at the step window's end — TTFT lands exactly once, at the
        true first-token time (rollback re-prefills keep their original
        stamp and never re-stream)."""
        if not self._chunk_done:
            return
        now = self._now()
        for r in self._chunk_done:
            if r.first_token_t is None:
                r.first_token_t = now
                if r.on_token is not None:
                    r.on_token(r.output[-1], r)
        self._chunk_done = []

    # ----------------------------------------- disaggregated prefill pool
    def _pf_ready_t(self) -> Optional[float]:
        """Engine-clock time the earliest in-flight prefill-pool job
        finishes (None when the pool is idle or every job is collected) —
        an idle decode pool fast-forwards to it like a next arrival."""
        ts = [j.job.ready_t for j in self._pf_jobs.values()
              if not j.collected]
        return min(ts) - self._clock0 if ts else None

    def _dispatch_prefills(self) -> None:
        """Route every fresh prefill in the waiting queue to the prefill
        pool.  Preempted requests (``needs_prefill`` False) stay for
        normal admission; pool queueing is the workers' own FIFO lanes."""
        if not self._disagg:
            return
        for r in [w for w in self.waiting if w.needs_prefill]:
            self.waiting.remove(r)
            self._dispatch_one(r)

    def _dispatch_one(self, r: Request) -> None:
        """One disaggregated prefill: run the REAL forward now (tokens are
        computed exactly as the colocated path computes them), occupy the
        least-loaded pool worker's lane for the simulated prefill window,
        and put the finished KV blocks on the DCN wire — each block floored
        at the simulated time its prefill chunk produces it, so the stream
        pipelines under the tail of the prefill.

        Accounting keeps the clock identity exact: the window is charged
        ``prefill_s`` AND ``hidden_s`` (it never occupies the decode
        accelerator), the stream is charged writeback-style, and any
        not-yet-landed tail is attached to the ADOPTING step's wait set —
        where a stall surfaces on the clock like an in-flight reload.
        """
        te = self.runtime.transfers
        prefix = r.prompt + r.output
        n = len(prefix)
        logits, out, npre, n_pad = self._prefill_forward(prefix)
        k = v = None
        if self.L_kv:
            kk, vv = out.kv
            if npre:
                kk, vv = kk[:, :, npre:], vv[:, :, npre:]
            k = kk[:, 0].float().cpu().numpy()
            v = vv[:, 0].float().cpu().numpy()

        # pool worker with the earliest-free lane; FIFO queueing on busy
        # workers is the lane's busy-until time
        lanes = [f"pf{i}" for i in range(self._pf_workers)]
        lane = min(lanes, key=te.channel_busy_until)
        s0 = te.channel_busy_until(lane)
        w = self._prefill_window_s(n)
        job = Transfer(("pf", r.req_id), Tier.LOCAL_HBM, Tier.LOCAL_HBM,
                       0, w, client="prefill", lane=lane)
        te.submit(job)
        self.stats.prefill_s += w
        self.stats.hidden_s += w

        # stream finished blocks over the DCN lane, round-robin over the
        # remote hosts.  Block j is produced when its prefill chunk
        # completes: with chunked prefill that is the chunk boundary
        # covering it, otherwise the end of the whole window (matching
        # the colocated engine, where KV lands at the prefill's end).
        stream: List[Transfer] = []
        if self.L_kv:
            dev = self._stream_devices[
                r.req_id % len(self._stream_devices)]
            bb = self.kv_mgr.block_nbytes
            nb = math.ceil(n / self.bs)
            # blocks produced at the same instant ship as ONE coalesced
            # DCN batch (transfer coalescing — one wire setup per prefill
            # chunk instead of per block); with unchunked prefill the
            # whole request is a single batch
            groups: Dict[float, List[Transfer]] = {}
            for j in range(nb):
                if self._chunk_tokens is not None:
                    m = min(math.ceil((j + 1) * self.bs / self._chunk_tokens)
                            * self._chunk_tokens, n)
                    produced = s0 + min(self._prefill_window_s(m), w)
                else:
                    produced = s0 + w
                tr = te.transfer(("pfs", r.req_id, j), bb,
                                 Tier.PEER_HBM, Tier.LOCAL_HBM,
                                 client="kv", device=dev)
                groups.setdefault(produced, []).append(tr)
            for produced in sorted(groups):
                members = groups[produced]
                te.submit_coalesced(members, not_before=produced)
                for tr in members:
                    self.stats.reload_s += tr.seconds
                    self.stats.writeback_s += tr.seconds
                    stream.append(tr)

        nxt = self._sample(_host(logits[0, npre + n - 1]))
        if not r.output:
            r.output.append(int(nxt))
            self.stats.tokens_out += 1
            # TTFT is the prefill pool's job end: the first token goes
            # straight back to the client from the prefill host — it does
            # not wait for the KV stream (the stream gates only decode)
            if r.first_token_t is None:
                r.first_token_t = (s0 + w) - self._clock0
        r.prefill_pos = n
        r.needs_prefill = False
        self._prefilling.append(r)
        self._pf_jobs[r.req_id] = _PrefillJob(
            r, job, stream, n, k, v, out.states)

    def _collect_streams(self) -> None:
        """Move requests whose pool prefill has finished back into the
        waiting queue (in job-completion order) for decode admission.
        The KV stream may still be in flight — adoption attaches its tail
        to the step's wait set, exactly like an in-flight prefix reload."""
        if not self._pf_jobs:
            return
        ready = sorted((j for j in self._pf_jobs.values()
                        if not j.collected and j.job.done),
                       key=lambda j: (j.job.ready_t, j.r.req_id))
        for j in ready:
            j.collected = True
            self._prefilling.remove(j.r)
            self.waiting.append(j.r)

    def _adopt_streamed(self, r: Request) -> None:
        """Decode-pool adoption of a streamed prefill: allocate the
        blocks in the local pool, fill them from the streamed payload, and
        gate this step's decode on the stream tail.  The shape mirrors
        prefix-cache adoption — zero prefill compute on this accelerator,
        eviction write-backs the allocations force charged off-path."""
        job = self._pf_jobs.pop(r.req_id)
        n = job.n
        row = r.row
        if self.L_kv:
            n_pad = job.k.shape[1]
            nb = math.ceil(n / self.bs)
            for j in range(nb):
                slot, ops = self.kv_mgr.allocate_block(r.req_id, j,
                                                       j * self.bs)
                self._charge_writeback(ops)
                lo, hi = j * self.bs, min((j + 1) * self.bs, n_pad)
                self.pool_k[:, slot, :hi - lo] = torch.from_numpy(
                    job.k[:, lo:hi]).to(self.device)
                self.pool_v[:, slot, :hi - lo] = torch.from_numpy(
                    job.v[:, lo:hi]).to(self.device)
                self.slot_req[slot] = row
                self.slot_base[slot] = j * self.bs
                ent = self.kv_mgr.table[(r.req_id, j)]
                ent.filled = min(self.bs, n - lo) if lo < n else 0
        if job.states is not None:
            self._set_state_row(row, job.states)
        self.row_tokens[row] = r.output[-1]
        self.row_pos[row] = len(r.prompt) + len(r.output) - 1
        # stream tail not yet landed: this step waits on it (stall
        # surfaces on the clock; its seconds were charged at dispatch)
        self._step_waits.extend(t for t in job.stream if not t.done)
        if r.on_token is not None:
            r.on_token(r.output[0], r)

    def _step_window(self, n_dec: int, chunk_tokens: int,
                     w_dec: float) -> float:
        """One iteration's accelerator window.  A prefill chunk rides the
        decode pass's weight read, so its marginal cost is its flops; a
        step with no decoders pays a standalone prefill window (which the
        shared :meth:`_prefill_window_s` floors at one weight read)."""
        if n_dec == 0:
            return self._prefill_window_s(chunk_tokens)
        if chunk_tokens <= 0:
            return w_dec
        fused = max((n_dec + chunk_tokens) * self._t_flop_tok,
                    self._t_weights)
        base = max(n_dec * self._t_flop_tok, self._t_weights)
        return w_dec + fused - base

    def _bubble_step(self) -> None:
        """The batch is empty while work is queued but not admissible
        (capacity or policy hold).  The legacy engine spun a zero-clock
        step; on the event timeline that freezes deadline policies and
        burns ``max_steps``.  Advance to the next event that can change
        admissibility — the next arrival, else one weight-read window —
        and charge the gap to its own ``bubble_s`` accounting class."""
        now = self._now()
        events = [t for t in (self.next_arrival_t(), self._pf_ready_t())
                  if t is not None and t > now]
        t = min(events) if events else now + self._t_weights
        dt = t - now
        self.stats.bubble_s += dt
        self.runtime.transfers.drain_until(self._clock0 + t)
        self._sync_clock()
        self._track_occupancy(dt, 0)

    def _sample(self, logits: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits))
        p = logits.astype(np.float64) / self.temperature
        p = np.exp(p - p.max())
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    # --------------------------------------------------------- accounting
    def _sync_clock(self) -> None:
        self.stats.clock_s = self.runtime.transfers.now - self._clock0

    def _charge_writeback(self, ops) -> float:
        """Eviction write-outs: charged to reload_s but off the critical
        path — in async mode they occupy the outbound link lanes.  With a
        planner the burst is submitted immediately as coalesced batches
        (one setup per outbound lane) — write-backs never wait for the
        step flush, so a same-key reload can chain behind them."""
        if self._planner is not None:
            _done, t = self._planner.submit(list(ops))
            self.stats.reload_s += t
            self.stats.writeback_s += t
            return t
        t = self.runtime.transfers.schedule(ops)
        self.stats.reload_s += t
        self.stats.writeback_s += t
        if self.mode == "async":
            for op in ops:
                self.runtime.transfers.submit(op)
        return t

    def _charge_critical(self, ops) -> float:
        """Transfers some read of the CURRENT step depends on.  Sync mode
        pre-sums them; async mode queues them and the step waits at the end
        of its compute window.  With a planner they are BUFFERED instead —
        the whole step's critical set is coalesced per lane at
        :meth:`_flush_step_plan`, which is where their time is charged."""
        if self._planner is not None:
            self._step_plan.extend(ops)
            return 0.0
        t = self.runtime.transfers.schedule(ops)
        self.stats.reload_s += t
        if self.mode == "async":
            for op in ops:
                self.runtime.transfers.submit(op)
            self._step_waits.extend(ops)
            self._step_critical_s += t
        return t

    def _flush_step_plan(self) -> float:
        """Coalesce + submit the step's buffered critical transfers: the
        per-step analogue of one batched ``harvest_gather`` per link lane.
        Called before any clock advance (prefill windows) and after the
        fetch stage, so batching never delays a transfer past the point
        its per-object twin would have been submitted."""
        if self._planner is None or not self._step_plan:
            return 0.0
        ops, self._step_plan = self._step_plan, []
        waits, eff = self._planner.submit(ops)
        self.stats.reload_s += eff
        self._step_waits.extend(waits)
        self._step_critical_s += eff
        return eff

    def _claim_prefetch(self, bid) -> None:
        """If an in-flight prefetch covers this read, wait on it instead of
        issuing a new transfer (its seconds were charged at issue)."""
        if self.prefetcher is None:
            return
        tr = self.prefetcher.claim(bid)
        if tr is not None and not tr.done:
            self._step_waits.append(tr)

    # ------------------------------------------------------------- stages
    def _preempt(self, sched_step: int) -> None:
        """Fair-scheduling preemption (§6.3): push the victim's blocks out
        to the Harvest tiers as write-backs."""
        victim = self.scheduler.pick_preemption(self.running, self.waiting,
                                                sched_step)
        if victim is None or not self.L_kv:
            return
        ops = self.kv_mgr.evict_request(victim.req_id)
        self._charge_writeback(ops)
        victim.state = "preempted"
        victim.preempt_count += 1
        self.running.remove(victim)
        self.free_rows.append(victim.row)
        self.row_of.pop(victim.req_id, None)
        victim.row = None
        self.waiting.append(victim)
        self.stats.preemptions += 1

    def _blocks_needed(self, req: Request) -> int:
        """Local-pool working set of one request: its prefix blocks plus
        one append-headroom block.  Used by admission capacity control AND
        as the prefetcher's slot floor, so the two can never diverge."""
        return math.ceil((len(req.prompt) + len(req.output) + 1) / self.bs) + 1

    def _prefill_window_s(self, tokens: int) -> float:
        """THE prefill cost formula, shared by ``_prefill`` (charging),
        ``_est_prefill_s`` (admission) and the chunked-prefill windows:
        one weight read floors the compute of ``tokens`` positions.
        Chunking changes the cost model in exactly this one place."""
        return max(max(tokens, 0) * self._t_flop_tok, self._t_weights)

    def _remaining_prefill_s(self, req: Request) -> float:
        """Prefill seconds still owed to an in-flight chunked prefill."""
        left = len(req.prompt) + len(req.output) - req.prefill_pos
        return self._prefill_window_s(left)

    def _est_prefill_s(self, req: Request) -> float:
        """Lower-bound service time to the first token: the prefill
        compute window over the not-yet-prefilled suffix.  Deadline-aware
        admission sheds a queued request once even this cannot land
        inside its TTFT SLO.  With chunked prefill the bound is per-chunk
        exact: chunks ride decode weight reads, so the remaining work is
        still flop-bound with a single weight-read floor."""
        n = len(req.prompt) + len(req.output) - req.prefill_pos
        if self._pcache is not None and req.prefill_pos == 0:
            # shedding decisions see the post-cache prefill cost: a cached
            # prefix starts its prefill from the divergence point
            n -= self._pcache.probe(req.prompt + req.output)
        return self._prefill_window_s(n)

    def _shed(self, r: Request, now: float) -> None:
        """Load shedding: reject a queued request without spending a
        prefill flop on it.  It retires in state ``rejected`` with a
        lifecycle record (counts against SLO attainment, not goodput)."""
        r.state = "rejected"
        r.finish_t = now
        self.finished.append(r)
        self.stats.rejected += 1
        self._record(r)

    def _record(self, r: Request) -> None:
        rec = RequestRecord(
            req_id=r.req_id, slo=r.slo, tenant=r.tenant, state=r.state,
            arrival_t=r.arrival_t, enqueue_t=r.enqueue_t, admit_t=r.admit_t,
            first_token_t=r.first_token_t, finish_t=r.finish_t,
            prompt_tokens=len(r.prompt), output_tokens=len(r.output),
            preemptions=r.preempt_count, ttft_slo_s=r.ttft_slo_s,
            e2e_slo_s=r.e2e_slo_s,
            cached_prefix_blocks=r.cached_prefix_blocks)
        self.stats.requests.append(rec)
        if self._controller is not None:
            self._controller.on_retire(rec, self._blocks_needed(r))

    def _admit(self) -> None:
        """Admission: the :class:`AdmissionPolicy` gates/orders the queue
        (and may shed), then the capacity filter keeps the pinned working
        sets inside the local pool (one append-headroom block per
        request), then the scheduler assigns batch rows.  Admitted
        requests are prefilled (new / rolled back) or resumed (reload
        their evicted prefix)."""
        now = self._now()
        view = AdmissionView(
            now=now, free_rows=len(self.free_rows), num_slots=self.n_slots,
            pinned_blocks=sum(self._blocks_needed(r) for r in self.running),
            num_running=len(self.running),
            blocks_needed=self._blocks_needed,
            est_prefill_s=self._est_prefill_s,
            pending_prefill_s=sum(self._remaining_prefill_s(r)
                                  for r in self.running if r.needs_prefill))
        eligible, shed = self.admission.select(list(self.waiting), view)
        for r in shed:
            self.waiting.remove(r)
            self._shed(r, now)
        deferred = [w for w in self.waiting if w not in eligible]
        pinned_blocks = view.pinned_blocks
        # regime-dependent batch cap (stability controller, engaged only):
        # the `cap < self.B` guard means an uncapped controller leaves the
        # scheduler's choice set — and with it every admission decision —
        # bit-exact with the controller-free engine
        cap = self.B if self._controller is None \
            else self._controller.batch_cap
        admissible = []
        for cand in eligible:
            if cap < self.B and len(self.running) + len(admissible) >= cap:
                break
            need = self._blocks_needed(cand)
            if pinned_blocks + need > self.n_slots or not self.free_rows:
                break
            pinned_blocks += need
            admissible.append(cand)
        rest = [w for w in eligible if w not in admissible] + deferred
        self.waiting = admissible
        admitted = self.scheduler.admit(self.waiting, self.free_rows)
        self.waiting = self.waiting + rest
        for r in admitted:
            if r.admit_t is None:          # queue wait ends at FIRST admit
                r.admit_t = now
            self.running.append(r)
            self.row_of[r.req_id] = r.row
            self.kv_mgr.pinned.add(r.req_id)
            if r.needs_prefill:
                # chunked mode: the prefill advances in resumable chunks
                # from the next _prefill_chunks pass instead of inline
                if self._chunk_tokens is None:
                    self._prefill(r)
            elif r.req_id in self._pf_jobs:
                self._adopt_streamed(r)
            else:
                self._resume(r)

    def _resume(self, r: Request) -> None:
        """Resuming a preempted request: reload its blocks.  The reloads
        are critical for THIS step (the request decodes immediately); a
        lossy revocation while preempted forces a prefix rebuild."""
        nb = math.ceil((r.pos + 1) / self.bs)
        plan = self.kv_mgr.plan_reloads(
            [(r.req_id, j) for j in range(nb)])
        for bid in plan.touched:
            self._claim_prefetch(bid)
        t = self._charge_critical(plan.ops)
        if self.mode == "async":
            self._step_waits.extend(plan.attached)
        if plan.lost is not None:
            # lossy revocation while preempted: rebuild the prefix
            self.stats.recomputes += 1
            if self.prefetcher is not None:
                self.prefetcher.cancel_owner(r.req_id)
            self.kv_mgr.free_request(r.req_id)
            self._restart_prefill(r)
        else:
            self.row_tokens[r.row] = r.output[-1]
            self.row_pos[r.row] = r.pos
        if self.mode == "sync":
            self.stats.clock_s += t

    def _restart_prefill(self, r: Request) -> None:
        """Lossy-revocation rollback: the whole prefix must be rebuilt.
        With chunked prefill the rebuild is itself chunked (it resumes
        from the next ``_prefill_chunks`` pass without re-emitting the
        first token); otherwise it re-prefills inline, exactly the
        legacy recompute path."""
        r.needs_prefill = True
        r.prefill_pos = 0
        if self._chunk_tokens is None:
            self._prefill(r)

    def _plan_fetches(self, reqs: Optional[Sequence[Request]] = None
                      ) -> List[Tuple[Request, List[Tuple[int, int]]]]:
        """The read set of the CURRENT step: every decoding request's
        blocks up to its decode position.  Only transfers for these blocks
        may stall the step — everything else (write-backs, prefetches)
        rides the link lanes in the background."""
        if not self.L_kv:
            return []
        if reqs is None:
            reqs = self.running
        return [(r, [(r.req_id, j)
                     for j in range(math.ceil((r.pos + 1) / self.bs))])
                for r in list(reqs)]

    def _launch_transfers(self, plan, decoding: Optional[List[Request]] = None
                          ) -> float:
        """Make the planned blocks resident (fetch mode), allocate the
        append blocks the step writes, and charge/queue the transfers.
        Each request's blocks go through one batched
        :meth:`~repro_torch.core.kv_manager.KVOffloadManager.plan_reloads` —
        repeated keys submit once and blocks already on the wire attach
        their in-flight transfer to this step's read set."""
        reload_t = 0.0
        for r, bids in plan:
            rp = self.kv_mgr.plan_reloads(bids)
            for bid in rp.touched:
                self._claim_prefetch(bid)
                # keep the pool->row mapping fresh (prefetched blocks were
                # reloaded before their request had a batch row)
                ent = self.kv_mgr.table[bid]
                self.slot_req[ent.local_slot] = r.row
                self.slot_base[ent.local_slot] = ent.base_pos
            reload_t += self._charge_critical(rp.ops)
            if self.mode == "async":
                self._step_waits.extend(rp.attached)
            if rp.lost is not None:
                # lossy revocation: rebuild the whole prefix (recompute)
                self.stats.recomputes += 1
                if self.prefetcher is not None:
                    self.prefetcher.cancel_owner(r.req_id)
                self.kv_mgr.free_request(r.req_id)
                self._restart_prefill(r)
                if r.needs_prefill and decoding is not None and r in decoding:
                    # chunked rebuild: the request sits out this step's
                    # decode (its pool rows are gone until re-prefilled)
                    decoding.remove(r)
        reload_t += self._allocate_append_blocks(
            self.running if decoding is None else decoding)
        return reload_t

    def _allocate_append_blocks(self, reqs: Sequence[Request]) -> float:
        """Allocate a block wherever a position crosses an append boundary.
        The slot must be free before the decode kernel writes, so any
        eviction it forces is on the critical path."""
        self._append_slot = np.full((self.B,), self.n_slots, np.int32)
        self._append_off = np.zeros((self.B,), np.int32)
        t_total = 0.0
        for r in reqs:
            pos = r.pos
            j = pos // self.bs
            if self.L_kv:
                if (r.req_id, j) not in self.kv_mgr.table:
                    slot, ops = self.kv_mgr.allocate_block(r.req_id, j,
                                                           j * self.bs)
                    t_total += self._charge_critical(ops)
                    self.slot_req[slot] = r.row
                    self.slot_base[slot] = j * self.bs
                ent = self.kv_mgr.table[(r.req_id, j)]
                self._append_slot[r.row] = ent.local_slot
                self._append_off[r.row] = pos % self.bs
                ent.filled = max(ent.filled, pos % self.bs + 1)
        return t_total

    def _estimate_compute(self, n_dec: Optional[int] = None) -> float:
        """Decode window: weight-read bound below the batch crossover.
        With a :class:`SpecDecodeConfig` the window is the amortized
        draft+verify cost per landed token (the seam charges speculative
        clock without changing emitted tokens)."""
        if n_dec is None:
            n_dec = len(self.running)
        base = max(n_dec * self._t_flop_tok, self._t_weights)
        sd = self._spec
        if sd is None or n_dec == 0:
            return base
        k = sd.draft_tokens
        draft = k * sd.draft_cost_frac * base
        verify = max((k + 1) * n_dec * self._t_flop_tok, self._t_weights)
        st = self._spec_stats
        st["draft_tokens"] += k * n_dec
        st["verify_tokens"] += (k + 1) * n_dec
        st["verify_passes"] += 1
        st["expected_accepted"] = sd.expected_accepted()
        return (draft + verify) / sd.expected_accepted()

    def _compute(self):
        """Run the real decode step over the batch; returns logits.  The
        step appends this step's k/v to ``pool_k``/``pool_v`` in place."""
        def dev(a):
            return torch.from_numpy(a).to(self.device)

        pos = dev(self.row_pos)
        state = M.DecodeState(
            tokens=dev(self.row_tokens),
            pos=pos,
            kv=None if not self.L_kv else M.KVPools(
                pool_k=self.pool_k, pool_v=self.pool_v,
                slot_req=dev(self.slot_req),
                slot_base=dev(self.slot_base),
                append_slot=dev(self._append_slot),
                append_off=dev(self._append_off)),
            peer=None, states=self.states,
            # M-RoPE of text: the (t, h, w) ids all equal the position
            positions_3d=(pos[:, None].expand(-1, 3)
                          if self.cfg.rope_style == "mrope" else None))
        logits, new_state = self._decode_fn(self.params, state)
        # rows without a request step their states too; a later prefill
        # overwrites the row
        self.states = new_state.states
        return logits

    def _account_step(self, compute_t: float, reload_t: float,
                      prefill_share: float = 0.0) -> None:
        """Advance the simulated clock by one decode step.
        ``prefill_share`` is the slice of the window owed to interleaved
        prefill chunks (charged to ``prefill_s``, zero on the legacy
        paths).  Async mode consumes — then clears — the step's critical
        waits here, so critical transfers charged by an end-of-step
        refill admission carry into the NEXT step's wait set instead of
        being orphaned."""
        self.stats.compute_s += compute_t - prefill_share
        self.stats.prefill_s += prefill_share
        te = self.runtime.transfers
        if self.mode == "sync":
            step_t = te.overlap(compute_t, reload_t, enabled=self.overlap)
            self.stats.clock_s += step_t
            self.stats.hidden_s += compute_t + reload_t - step_t
            return
        t0 = te.now
        compute_end = t0 + compute_t
        ready = max((tr.ready_t for tr in self._step_waits if not tr.done),
                    default=compute_end)
        end = max(compute_end, ready)
        stall = end - compute_end
        te.drain_until(end)
        self.stats.stall_s += stall
        self.stats.hidden_s += self._step_critical_s - stall
        self._step_waits = []
        self._step_critical_s = 0.0
        self._sync_clock()
        self._track_occupancy(end - t0, self.B - len(self.free_rows))

    def _track_occupancy(self, window_s: float, occupied: int) -> None:
        """Time-weighted batch-row occupancy (``q.batch.*`` counters):
        ``occupancy`` is the mean over every step/bubble window,
        ``q_occupancy`` the mean over windows where the ready queue was
        non-empty — continuous batching's promise is the latter pinned at
        1.0 whenever capacity allows."""
        qb = self._qbatch
        if qb is None or window_s <= 0:
            return
        qb["q.batch.row_s"] += occupied * window_s
        qb["q.batch.cap_s"] += self.B * window_s
        qb["q.batch.occupancy"] = qb["q.batch.row_s"] / qb["q.batch.cap_s"]
        if self.waiting:
            qb["q.batch.q_row_s"] += occupied * window_s
            qb["q.batch.q_cap_s"] += self.B * window_s
            qb["q.batch.q_occupancy"] = (qb["q.batch.q_row_s"]
                                         / qb["q.batch.q_cap_s"])

    def _commit_and_sample(self, logits, reqs: Sequence[Request]) -> None:
        """Sample one token per decoding request, commit it, and stream it
        to the request's callback (the clock has already advanced past
        this step's window, so the timestamp is the token's ready time)."""
        logits_np = _host(logits)
        now = self._now()
        for r in reqs:
            tok = self._sample(logits_np[r.row])
            r.output.append(tok)
            r.decode_steps += 1
            self.stats.tokens_out += 1
            self.row_tokens[r.row] = tok
            self.row_pos[r.row] = r.pos
            if r.first_token_t is None:
                r.first_token_t = now
            if r.on_token is not None:
                r.on_token(tok, r)

    def _retire(self) -> None:
        """Release finished requests: batch row, KV blocks, prefetches."""
        now = self._now()
        for r in list(self.running):
            if not r.done:
                continue
            r.state = "done"
            r.finish_t = now
            self._record(r)
            self.running.remove(r)
            self.finished.append(r)
            self.free_rows.append(r.row)
            for slot in np.nonzero(self.slot_req == r.row)[0]:
                self.slot_req[slot] = -1
            if self._pcache is not None and self.L_kv:
                # publish-on-retire: the prompt's full blocks transfer to
                # the trie (zero copy) instead of being freed below
                self._pcache.publish(r.req_id, r.prompt)
            self.kv_mgr.free_request(r.req_id)
            if self.prefetcher is not None:
                self.prefetcher.cancel_owner(r.req_id)
            self.row_of.pop(r.req_id, None)
            self._req_slo.pop(r.req_id, None)
            r.row = None

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """One engine iteration through the staged pipeline.  Returns False
        when all work is done.  Clock-driven arrivals become visible
        first; a request-free gap fast-forwards the clock to the next
        arrival (charged as ``idle_s``) instead of spinning steps."""
        self._admit_arrivals()
        if self._disagg:
            self._collect_streams()
            self._dispatch_prefills()
        if not (self.waiting or self.running):
            nxt = self.next_arrival_t()
            pf = self._pf_ready_t()
            events = [t for t in (nxt, pf) if t is not None]
            if not events:
                return False
            self._idle_until(min(events))
            self._admit_arrivals()
            if self._disagg:
                self._collect_streams()
                self._dispatch_prefills()
        sched_step = self.stats.steps
        self.kv_mgr.pinned = {r.req_id for r in self.running}
        # control tick BEFORE admission so this step's shed/defer/cap
        # decisions see estimates refreshed through the latest arrivals
        # (covers the bubble path too — each bubble advances the clock,
        # so an engaged controller keeps ticking toward disengagement)
        if self._controller is not None:
            self._controller.poll(self._now())
        if self.mode == "sync":
            # async consumes these in _account_step so refill-time charges
            # carry into the next step's wait set; sync never queues any
            self._step_waits = []
            self._step_critical_s = 0.0

        self._preempt(sched_step)
        self._admit()
        chunk_tokens = self._prefill_chunks()
        if not self.running:
            if self.mode == "async" and self.waiting:
                # queued work, empty batch: a scheduling bubble with its
                # own accounting class (the sync legacy path keeps the
                # zero-clock spin for bit-exactness)
                self._bubble_step()
            self.stats.steps += 1
            return bool(self.waiting or self._arrivals or self._pf_jobs)

        # the decode set: running minus in-flight prefills minus prefills
        # that finished THIS step (their first token IS this window's work)
        decoding = [r for r in self.running
                    if not r.needs_prefill and r not in self._chunk_done]
        plan = self._plan_fetches(decoding)
        reload_t = self._launch_transfers(plan, decoding)
        # coalesce + submit the step's whole critical set: one batched
        # lane occupancy per link direction (no-op without a planner)
        reload_t += self._flush_step_plan()
        # timeline-driven pressure: external budget changes land HERE, while
        # this step's transfers are already in flight on the lanes, instead
        # of in the gap between steps (a revoked peer block that this step's
        # reads depend on has already been made local above, so the step
        # itself is safe — the revocation hits the resident-in-peer tail)
        self._poll_pressure()
        n_dec = len(decoding)
        w_dec = self._estimate_compute(n_dec) if n_dec else 0.0
        compute_t = self._step_window(n_dec, chunk_tokens, w_dec)
        if self.prefetcher is not None:
            # worst-case slots the next allocations may claim: one append
            # block per running request + the head-of-line waiter's whole
            # working set (prefill allocations OR resume reloads of blocks
            # the prefetcher did not cover) — so a prefetch can never be
            # the reason a later allocation evicts
            floor = len(self.running) + (
                self._blocks_needed(self.waiting[0]) if self.waiting else 0)
            for op in self.prefetcher.run(compute_t, running=self.running,
                                          waiting=self.waiting,
                                          slot_floor=floor):
                # speculative seconds: accounted as hidden at issue; any
                # residual wait surfaces as stall in a later step.  lane_s
                # is the occupancy actually charged (== seconds solo, less
                # the saved setup inside a coalesced batch)
                self.stats.reload_s += op.lane_s
                self.stats.hidden_s += op.lane_s
        logits = self._compute() if n_dec else None
        self._account_step(compute_t, reload_t,
                           prefill_share=compute_t - w_dec)
        if logits is not None:
            self._commit_and_sample(logits, decoding)
        self._commit_first_tokens()
        self._retire()
        if self._refill and self.free_rows:
            # iteration-level slot refill: rows freed by _retire and
            # arrivals that landed inside this step's window meet NOW,
            # not at the top of the next step — a row never idles across
            # a step boundary while work is queued
            self._admit_arrivals()
            if self._disagg:
                self._collect_streams()
                self._dispatch_prefills()
            if self.waiting:
                # the refill admission sees the post-step clock: a long
                # stalled step may have carried queued requests past
                # their deadlines, so the controller must observe the
                # new time BEFORE this pass (not at the next step's top)
                if self._controller is not None:
                    self._controller.poll(self._now())
                self._admit()

        if self._timeline_ticks is not None:
            self._poll_pressure()
        elif self.monitor is not None and sched_step % 4 == 0:
            self.runtime.tick()   # legacy stepwise pressure drive
        self.stats.steps += 1
        return True

    def _poll_pressure(self) -> int:
        """Timeline drive of the availability monitor (async mode with a
        ``tick_interval_s``-configured monitor): per-device budget updates
        fire on the transfer clock, mid-pipeline."""
        if self._timeline_ticks is None:
            return 0
        fired = self.runtime.poll_pressure()
        self._timeline_ticks += fired
        return fired

    def run(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if not self.step():
                break
        return self.finalize()

    def finalize(self) -> EngineStats:
        """Snapshot the unified metrics and assert the clock identity.
        Idempotent — ``run``/``run_until`` call it after every drive."""
        if self.mode == "async" and (self._step_waits
                                     or self._step_critical_s):
            # a truncated run (max_steps) can leave refill-time critical
            # transfers unconsumed; classify them exactly like a step
            # would so the clock identity stays exact
            te = self.runtime.transfers
            ready = max((tr.ready_t for tr in self._step_waits
                         if not tr.done), default=te.now)
            stall = max(ready - te.now, 0.0)
            te.drain_until(max(ready, te.now))
            self.stats.stall_s += stall
            self.stats.hidden_s += self._step_critical_s - stall
            self._step_waits = []
            self._step_critical_s = 0.0
            self._sync_clock()
        self.stats.metrics = self.runtime.stats()
        self.stats.check_clock_identity()
        return self.stats
