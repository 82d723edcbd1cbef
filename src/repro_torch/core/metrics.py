"""The paper's §5.1 evaluation metrics: gain and idle time.

gain       = (best single-device time - hybrid time) / best single time
idle_i     = fraction of the hybrid makespan device i spent not computing
efficiency = 1 - mean(idle)          (paper reports ~90% on average)

``ServeStats`` is the scheduler's exported counter/EWMA block: every
admission-control and placement decision increments exactly one
counter, so ``submitted == completed + rejected + shed + in-flight``
is an auditable invariant (a request dropped *without* a structured
rejection is a bug, not load).  ``FleetStats`` is the same block one
tier up, for the fleet router.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence


def _pctl_window(default: int = 256) -> int:
    """Ring size for ``Percentile`` (``REPRO_SERVE_PCTL_WINDOW``).

    Bigger windows stabilize p99 at high arrival rates (256 samples
    undersizes the full-13 mix) at the cost of a sorted copy per
    quantile read — see docs/KNOBS.md."""
    try:
        return max(int(os.environ.get("REPRO_SERVE_PCTL_WINDOW",
                                      str(default))), 16)
    except ValueError:
        return default


class EWMA:
    """Thread-safe exponentially weighted moving average (load
    telemetry: queue depth, wait, service time)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._value = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        with self._lock:
            self._value = (x if self._n == 0
                           else self.alpha * x
                           + (1 - self.alpha) * self._value)
            self._n += 1

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def n(self) -> int:
        with self._lock:
            return self._n


class Percentile:
    """Thread-safe ring buffer of recent observations with quantile
    reads.  EWMAs hide the tail; hedging keys off p99 service time, so
    the scheduler keeps the last ``maxlen`` raw samples instead."""

    def __init__(self, maxlen: Optional[int] = None):
        self._buf: deque = deque(maxlen=_pctl_window()
                                 if maxlen is None else maxlen)
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        with self._lock:
            self._buf.append(x)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._buf:
                return None
            vals = sorted(self._buf)
        q = min(max(q, 0.0), 1.0)
        return vals[int(q * (len(vals) - 1))]

    @property
    def n(self) -> int:
        with self._lock:
            return len(self._buf)


@dataclass
class ServeStats:
    """Scheduler load telemetry.  Counter increments and ``snapshot()``
    both hold the stats object's own ``lock`` (a *leaf* lock: never
    acquire a scheduler/router lock while holding it), so a concurrent
    snapshot can't observe a torn multi-field update and the
    ``in_flight`` invariant audit is exact.  The EWMAs are internally
    thread-safe."""
    lock: threading.RLock = field(default_factory=threading.RLock,
                                  repr=False, compare=False)
    submitted: int = 0
    completed: int = 0
    failed: int = 0                  # execution raised; future rejected
    rejected_full: int = 0           # queue_full admission rejections
    rejected_shutdown: int = 0
    rejected_failure: int = 0        # lane failure + retry budget spent,
    #                                  or no alive lane to place on
    shed_deadline: int = 0           # expired or unmeetable deadlines
    shed_brownout: int = 0           # best-effort shed while degraded
    batches: int = 0                 # coalesced executions (>=2 requests)
    batched_requests: int = 0        # requests that rode in a batch
    merged_batches: int = 0          # batches stacked into ONE kernel
    #                                  call (adapter merge/demux hooks)
    dedicated: int = 0               # executions placed on one group
    shared: int = 0                  # executions work-shared (paper split)
    probe_runs: int = 0              # calibration probe executions paid
    engine_steps: int = 0            # continuous-engine batched step calls
    engine_joins: int = 0            # rows joined a running batch at a
    #                                  step boundary (continuous batching)
    engine_evictions: int = 0        # finished rows evicted from slots
    engine_cancellations: int = 0    # rows dropped at a step boundary
    #                                  because their future already
    #                                  resolved (hedge loser / shutdown)
    engine_preemptions: int = 0      # step loops that yielded the lane
    #                                  to latency-class deadline work
    retries: int = 0                 # requests requeued after lane fault
    hedges: int = 0                  # duplicate executions launched
    hedge_wins: int = 0              # hedge resolved before the original
    failovers: int = 0               # lane deaths that triggered requeue
    watchdog_timeouts: int = 0       # executions past k*est_span/floor
    lane_deaths: int = 0             # alive -> dead transitions
    lane_revivals: int = 0           # dead -> alive (rejoin) transitions
    queue_depth: EWMA = field(default_factory=EWMA)
    wait_s: EWMA = field(default_factory=EWMA)       # submit -> start
    service_s: EWMA = field(default_factory=EWMA)    # start -> resolve
    latency_s: EWMA = field(default_factory=EWMA)    # submit -> resolve
    service_q: Percentile = field(default_factory=Percentile)
    #                                  raw service-time tail (hedge p99)

    def inc(self, **deltas: int) -> None:
        """Atomic multi-counter increment under the leaf lock — the
        one write path, so a snapshot never sees half an update."""
        with self.lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    @property
    def in_flight(self) -> int:
        with self.lock:
            return (self.submitted - self.completed - self.failed
                    - self.rejected_full - self.rejected_shutdown
                    - self.rejected_failure - self.shed_deadline
                    - self.shed_brownout)

    def snapshot(self) -> Dict[str, float]:
        with self.lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> Dict[str, float]:
        return {
            "submitted": self.submitted, "completed": self.completed,
            "failed": self.failed, "rejected_full": self.rejected_full,
            "rejected_shutdown": self.rejected_shutdown,
            "rejected_failure": self.rejected_failure,
            "shed_deadline": self.shed_deadline,
            "shed_brownout": self.shed_brownout,
            "batches": self.batches,
            "batched_requests": self.batched_requests,
            "merged_batches": self.merged_batches,
            "dedicated": self.dedicated, "shared": self.shared,
            "probe_runs": self.probe_runs,
            "engine_steps": self.engine_steps,
            "engine_joins": self.engine_joins,
            "engine_evictions": self.engine_evictions,
            "engine_cancellations": self.engine_cancellations,
            "engine_preemptions": self.engine_preemptions,
            "retries": self.retries,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "failovers": self.failovers,
            "watchdog_timeouts": self.watchdog_timeouts,
            "lane_deaths": self.lane_deaths,
            "lane_revivals": self.lane_revivals,
            "in_flight": self.in_flight,
            "queue_depth_ewma": self.queue_depth.value,
            "wait_ewma_s": self.wait_s.value,
            "service_ewma_s": self.service_s.value,
            "latency_ewma_s": self.latency_s.value,
        }

    def row(self) -> str:
        rejected = (self.rejected_full + self.rejected_shutdown
                    + self.rejected_failure)
        return (f"serve: submitted={self.submitted} "
                f"completed={self.completed} failed={self.failed} "
                f"rejected={rejected} "
                f"shed={self.shed_deadline + self.shed_brownout} "
                f"retries={self.retries} batches={self.batches} "
                f"dedicated={self.dedicated} shared={self.shared} "
                f"depth~{self.queue_depth.value:.1f} "
                f"latency~{self.latency_s.value * 1e3:.1f}ms")


@dataclass
class FleetStats:
    """Router-tier telemetry (one per ``serve.router.Router``).

    Same auditable-invariant design as ``ServeStats``, one level up:
    every submitted request lands in exactly one of completed / failed /
    a structured-rejection bucket, so ``in_flight`` going to zero means
    every client future resolved exactly once — across worker deaths,
    resubmits and duplicate late completions (which are counted, not
    delivered: the first resolution wins).  Increments and
    ``snapshot()`` hold the stats object's own leaf ``lock`` (same
    torn-read contract as ``ServeStats``)."""
    lock: threading.RLock = field(default_factory=threading.RLock,
                                  repr=False, compare=False)
    submitted: int = 0
    completed: int = 0
    failed: int = 0                  # application error from a worker
    rejected_upstream: int = 0       # worker's structured rejection,
    #                                  passed through to the client
    rejected_failure: int = 0        # router-issued: resubmit budget
    #                                  exhausted, or no alive worker
    rejected_shutdown: int = 0       # router draining / shut down
    shed_brownout: int = 0           # best-effort shed while degraded
    resubmits: int = 0               # requests re-hashed off a dead
    #                                  worker onto a survivor
    duplicate_results: int = 0       # late completions for an already-
    #                                  resolved request (no-op by design)
    spills: int = 0                  # routed off the affinity worker
    #                                  because it was backlogged
    worker_deaths: int = 0           # alive/suspect -> dead transitions
    worker_suspects: int = 0         # alive -> suspect (missed beats)
    worker_rejoins: int = 0          # suspect/dead -> alive transitions
    latency_s: EWMA = field(default_factory=EWMA)
    latency_q: Percentile = field(default_factory=Percentile)

    def inc(self, **deltas: int) -> None:
        """Atomic multi-counter increment under the leaf lock."""
        with self.lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    @property
    def in_flight(self) -> int:
        with self.lock:
            return (self.submitted - self.completed - self.failed
                    - self.rejected_upstream - self.rejected_failure
                    - self.rejected_shutdown - self.shed_brownout)

    def snapshot(self) -> Dict[str, float]:
        with self.lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> Dict[str, float]:
        return {
            "submitted": self.submitted, "completed": self.completed,
            "failed": self.failed,
            "rejected_upstream": self.rejected_upstream,
            "rejected_failure": self.rejected_failure,
            "rejected_shutdown": self.rejected_shutdown,
            "shed_brownout": self.shed_brownout,
            "resubmits": self.resubmits,
            "duplicate_results": self.duplicate_results,
            "spills": self.spills,
            "worker_deaths": self.worker_deaths,
            "worker_suspects": self.worker_suspects,
            "worker_rejoins": self.worker_rejoins,
            "in_flight": self.in_flight,
            "latency_ewma_s": self.latency_s.value,
        }

    def row(self) -> str:
        rejected = (self.rejected_upstream + self.rejected_failure
                    + self.rejected_shutdown)
        return (f"fleet: submitted={self.submitted} "
                f"completed={self.completed} failed={self.failed} "
                f"rejected={rejected} brownout={self.shed_brownout} "
                f"resubmits={self.resubmits} "
                f"duplicates={self.duplicate_results} "
                f"spills={self.spills} deaths={self.worker_deaths} "
                f"rejoins={self.worker_rejoins} "
                f"latency~{self.latency_s.value * 1e3:.1f}ms")


@dataclass(frozen=True)
class HybridResult:
    workload: str
    hybrid_time: float               # MEASURED makespan (+comm+merge)
    single_times: Dict[str, float]   # device-group name -> alone time
    busy_times: Dict[str, float]     # device-group name -> busy during hybrid
    analytic_time: float = 0.0       # model makespan from the WorkPlan
    steals: int = 0                  # chunks moved by work stealing
    n_chunks: int = 0
    mode: str = ""                   # "threads" | "virtual" | "sequential"
    # overlap model evaluated with THIS run's observed per-unit times:
    # checks the paper's max(t_fast, t_slow) + comm *structure* without
    # the planning-EWMA's sensitivity to machine-speed drift
    analytic_observed_time: float = 0.0

    @property
    def model_agreement(self) -> float:
        """|measured - analytic| / analytic (0 when no analytic time)."""
        if self.analytic_time <= 0:
            return 0.0
        return abs(self.hybrid_time - self.analytic_time) / self.analytic_time

    @property
    def overlap_agreement(self) -> float:
        """|measured - observed-throughput model| / model."""
        if self.analytic_observed_time <= 0:
            return 0.0
        return (abs(self.hybrid_time - self.analytic_observed_time)
                / self.analytic_observed_time)

    @property
    def best_single(self) -> float:
        return min(self.single_times.values())

    @property
    def best_single_device(self) -> str:
        return min(self.single_times, key=self.single_times.get)

    @property
    def gain(self) -> float:
        return (self.best_single - self.hybrid_time) / self.best_single

    @property
    def idle_fracs(self) -> Dict[str, float]:
        return {d: max(0.0, (self.hybrid_time - b) / self.hybrid_time)
                for d, b in self.busy_times.items()}

    @property
    def resource_efficiency(self) -> float:
        idle = self.idle_fracs
        return 1.0 - sum(idle.values()) / len(idle) if idle else 1.0

    def row(self) -> str:
        idle = self.idle_fracs
        worst = max(idle.values()) if idle else 0.0
        extra = ""
        if self.analytic_time > 0:
            extra = (f"  model={self.analytic_time * 1e3:9.3f}ms "
                     f"(±{100 * self.model_agreement:.0f}%)")
        if self.steals:
            extra += f"  steals={self.steals}"
        return (f"{self.workload:8s} gain={100 * self.gain:6.1f}%  "
                f"idle={100 * worst:5.1f}%  "
                f"eff={100 * self.resource_efficiency:5.1f}%  "
                f"hybrid={self.hybrid_time * 1e3:9.3f}ms  "
                f"best-single[{self.best_single_device}]="
                f"{self.best_single * 1e3:9.3f}ms" + extra)


def summarize(results: Sequence[HybridResult]) -> str:
    lines = [r.row() for r in results]
    if results:
        avg_gain = sum(r.gain for r in results) / len(results)
        avg_eff = sum(r.resource_efficiency for r in results) / len(results)
        lines.append(f"{'MEAN':8s} gain={100 * avg_gain:6.1f}%  "
                     f"eff={100 * avg_eff:5.1f}%")
    return "\n".join(lines)
