"""Continuous-stream request scheduler over hybrid device groups.

This is the fleet-level application of the paper's thesis: the unit of
scheduling is no longer one work-shared call but a *stream* of
concurrent, heterogeneous requests, and for each one the scheduler
decides — from the PR-3 cost model and calibrated unit times — whether
to **dedicate** a device group (co-scheduling different requests on
different groups simultaneously), **work-share** it across all groups
(the §5.4.3 split, only when the projected makespan win exceeds the
split overhead), or let it **queue** behind the lane with the earliest
projected completion.

Architecture (all threads named ``serve-*`` for teardown auditing):

* ``submit()`` → bounded ``RequestQueue`` (admission control: a full
  queue is an immediate structured rejection, never a hang).
* one **dispatcher** thread pops requests, coalesces same-(workload,
  shape-bucket) arrivals inside a short batching window into one
  execution, scores placement against every group's projected-free
  time, sheds deadline-infeasible work, and hands executions to lanes.
* one **lane worker per group** executes dedicated placements pinned to
  the group's primary device; one **shared lane** worker executes
  work-shared placements through the (now lock-protected, shareable)
  ``HybridExecutor``.  Lane workers synchronize through per-group
  locks: a shared execution takes every group lock (sorted order — no
  deadlock), a dedicated one takes only its own, so dedicated work on
  group A genuinely overlaps dedicated work on group B.

Every execution updates the persistent ``CalibrationCache`` with the
measured seconds/unit for (workload, group), so placement *learns* each
workload's device affinity online — the 2.5-14x per-kernel spread of
Lee et al. is rediscovered from the scheduler's own traffic, and a
fresh process inherits it from disk (first scheduled call plans with
zero probes, PR 3's cold-start contract).

The groups are the detected pair: the ``accel`` group on the first
GPU and the ``host`` group on the CPU, or — with ``device="cpu"`` — the
simulated pair on the CPU.  A dedicated execution runs under its
group's device (``kernels.common.lane_device``; a GPU lane on a stream
of its own), which every adapter's ``run_one`` reads to pick that
device's copy of its inputs: torch tensors follow no default device.

Adapters whose spec carries a ``stepper`` additionally route through
the **continuous-batching engine** (``serve/continuous.py``): the
decode step becomes the scheduling quantum, live requests stack into
one slot-batched call per step, and prefill/decode are disaggregated
across lanes from ``CostTerms`` priors
(``placement.plan_disaggregation`` — zero probes on a cold start).  On
the GPU + CPU pair the two lanes may be two devices; the engine runs
each phase under its group's device.  ``REPRO_SERVE_CONTINUOUS=0``
disables the route: stepper specs fall back to their monolithic
``run_one`` path.

**Fault tolerance** (the layer a heterogeneous placement needs most —
one sick lane silently poisons every projection built on it):

* a **watchdog** thread (``serve-watchdog``) tracks every lane's active
  execution; one that exceeds ``k × est_span`` (floor
  ``REPRO_SERVE_EXEC_TIMEOUT_S``) marks the lane *suspect*, flips
  ``GroupLoad.alive`` and **fails over**: the execution's unresolved
  requests re-enter the queue.  Idle lane workers heartbeat through
  ``ft.failure.HeartbeatMonitor`` so a wedged-but-not-executing lane is
  detected too.  A suspect lane whose stuck execution eventually
  completes rejoins automatically (its calibration entries were marked
  stale, so placement re-measures it instead of trusting pre-death
  numbers).
* **retry with exactly-once futures**: requeued requests carry a retry
  budget (``max_retries``); adapters are pure, so a duplicate
  execution is safe and the resolve-exactly-once ``ServeFuture`` makes
  whichever copy finishes first the only result.  Only
  ``LaneFailure``-typed errors (or a lane marked dead) retry —
  application errors still fail the future immediately.
* optional **hedging**: ``submit(..., hedge=True)`` requests get a
  duplicate execution on a second idle lane once the original runs
  past the hedge delay (``REPRO_SERVE_HEDGE_DELAY_S``; default: p99 of
  recent service times); first result wins, the loser is cancelled at
  the next iteration boundary (engine rows) or resolves into a no-op.
* **brownout degradation**: while any lane is dead, admission sheds
  best-effort submissions (``priority < 0``) with a structured
  rejection and dispatch stops lingering for batch coalescing;
  survivors' placement estimates use only alive peers for staleness
  shrinkage.  A revived lane rejoins through the existing exploration
  path.

Lifecycle: ``start()`` (implicit on first submit) → ``drain()`` (stop
admitting, finish everything accepted, every future resolved exactly
once) → ``shutdown()`` (drain + join all threads).  Env knobs:
``REPRO_SERVE_QUEUE`` (depth, default 256), ``REPRO_SERVE_WINDOW_MS``
(batch window, default 2), ``REPRO_SERVE_MAX_BATCH`` (default 8),
``REPRO_SERVE_SPAN_FACTOR`` (pins the otherwise self-probed
torch-vs-torch cross-lane contention factor),
``REPRO_SERVE_SPAN_FACTOR_HOST`` (pins the host-native-vs-torch
factor — the per-workload-class pricing),
``REPRO_SERVE_CONTINUOUS`` (step-quantum engine on/off, default on),
``REPRO_SERVE_STALE_TAU`` (staleness
decay time constant for placement estimates, seconds; 0 disables),
``REPRO_SERVE_EXEC_TIMEOUT_S`` (watchdog floor, default 30),
``REPRO_SERVE_MAX_RETRIES`` (retry budget, default 2),
``REPRO_SERVE_HEDGE_DELAY_S`` (hedge delay; 0 = p99-based).
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.async_executor import device_ctx, primary_device
from repro_torch.core.hybrid_executor import (DeviceGroup, HybridExecutor,
                                              detect_platform)
from repro_torch.core.metrics import ServeStats
from repro_torch.ft.failure import HeartbeatMonitor, LaneFailure
from repro_torch.kernels.common import sync_device
from repro_torch.obs import PlacementAudit, get_recorder, new_trace_id
from repro_torch.serve import continuous
from repro_torch.serve.placement import (SHARED, GroupLoad,
                                         PlacementDecision,
                                         deadline_feasible,
                                         degraded_fraction,
                                         plan_disaggregation, plan_placement)
from repro_torch.serve.request_queue import (SLO_BEST_EFFORT, SLO_LATENCY,
                                             Rejection, Request,
                                             RequestQueue, ServeFuture,
                                             resolve_slo_class)

_SHARED_LANE = "__shared__"

# live schedulers, so test teardown can stop anything a failing test
# leaked (tests/conftest.py joins serve-* threads through this)
_LIVE: "weakref.WeakSet[Scheduler]" = weakref.WeakSet()


def shutdown_all(timeout: float = 10.0) -> None:
    """Stop every live scheduler (test teardown hook)."""
    for s in list(_LIVE):
        try:
            s.shutdown(timeout=timeout, abort=True)
        except Exception:
            pass
    # engines created outside a scheduler (tests drive them directly)
    continuous.shutdown_all(timeout=timeout)


def continuous_enabled() -> bool:
    """Step-quantum engine routing on/off (REPRO_SERVE_CONTINUOUS)."""
    return os.environ.get("REPRO_SERVE_CONTINUOUS", "1").lower() not in (
        "0", "off", "false", "no")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# measured span factors, memoized per (device signature, lane class):
# every scheduler in a process (and every test) shares one ~100 ms
# probe per class
_SPAN_FACTOR_CACHE: Dict[tuple, float] = {}
_SPAN_FACTOR_LOCK = threading.Lock()


def _probe_pair(lane_a, lane_b, calibrate) -> float:
    """Time two lane callables solo then concurrently; returns the
    contention factor ``min(max(1, 2/capacity), 2)`` where
    ``capacity = (t_a + t_b) / t_both`` (2.0 = perfect overlap,
    ~1.0 = fully contended).  Summing per-lane solo times keeps
    device-speed asymmetry out of the number — under perfect overlap
    ``t_both ~= t_slow`` and the sum-based capacity still reads ~2,
    where a ``2*t_fast/t_both`` formula would misread asymmetry as
    contention.  ``calibrate`` returns per-lane iteration counts so
    each side runs ~30 ms."""
    iters = calibrate()
    t_solo = 0.0
    for fn, n in zip((lane_a, lane_b), iters):
        t0 = time.perf_counter()
        fn(n)
        t_solo += time.perf_counter() - t0
    threads = [threading.Thread(target=fn, args=(n,),
                                name="serve-span-probe")
               for fn, n in zip((lane_a, lane_b), iters)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_both = max(time.perf_counter() - t0, 1e-9)
    capacity = max(t_solo / t_both, 1e-3)
    # clamp to the model's meaningful range: 1.0 = perfect overlap,
    # 2.0 = a split's halves fully serialize.  Beyond 2 the probe is
    # measuring its own sync/thread overhead, and a runaway factor
    # would poison every dedicated projection too.
    return min(max(1.0, 2.0 / capacity), 2.0)


def _lane_device(g) -> torch.device:
    """A group's primary device (a group with no device: the CPU)."""
    return primary_device(g) or torch.device("cpu")


def _torch_lane(dev: torch.device):
    """A probe lane: a small matmul step on ``dev``, synchronised each
    iteration (launch + device time, as a request's run_one pays)."""
    x = torch.ones((512, 512), dtype=torch.float32, device=dev)

    def run(iters):
        if dev.type == "cuda":
            torch.cuda.set_device(dev)     # this probe thread's context
        for _ in range(iters):
            (x @ x) * 0.5 + 0.1
            sync_device(dev)
    return run


def _iters_for(lane) -> int:
    """Iterations for ~30 ms of ``lane`` (after one warm call)."""
    lane(1)
    t0 = time.perf_counter()
    lane(1)
    t_call = max(time.perf_counter() - t0, 1e-6)
    return max(int(0.03 / t_call), 3)


def measure_shared_span_factor(groups: Sequence[DeviceGroup]) -> float:
    """Self-probed cross-lane contention pricing for torch-vs-torch
    lane pairs: ``2 / capacity``.

    The shared-split candidate models perfect overlap; reality is the
    host's measured pairwise headroom.  Two lanes on the first two
    groups' primary devices (the card and the CPU on the real pair,
    the CPU twice on the simulated one) each run a small matmul, timed
    solo then concurrently (see ``_probe_pair``).  The factor
    multiplies the shared candidate's modeled makespan; the Scheduler
    pays the probe itself, once per process per device signature.
    ``REPRO_SERVE_SPAN_FACTOR`` pins the result (probe skipped)."""
    pinned = _env_float("REPRO_SERVE_SPAN_FACTOR", 0.0)
    if pinned > 0:
        return pinned
    if len(groups) < 2:
        return 1.0
    devs = [_lane_device(g) for g in list(groups)[:2]]
    key = tuple(str(d) for d in devs) + ("torch",)
    with _SPAN_FACTOR_LOCK:
        if key in _SPAN_FACTOR_CACHE:
            return _SPAN_FACTOR_CACHE[key]
        lanes = [_torch_lane(d) for d in devs]
        factor = _probe_pair(lanes[0], lanes[1],
                             lambda: tuple(_iters_for(ln) for ln in lanes))
        _SPAN_FACTOR_CACHE[key] = factor
        return factor


def measure_host_span_factor(groups: Sequence[DeviceGroup]) -> float:
    """Contention pricing for host-native-vs-torch lane pairs.

    Host-native adapters (single-core numpy that releases the
    interpreter lock, e.g. sort) overlap a torch lane near-perfectly
    where two torch lanes may contend, so pricing their
    shared/co-scheduled spans with the torch factor would suppress
    exactly the co-schedules the paper's affinity spread rewards.  One
    lane runs ``np.sort`` (the host class's archetype), the other the
    matmul on the first group's device; same solo-vs-concurrent
    capacity formula as the torch probe.
    ``REPRO_SERVE_SPAN_FACTOR_HOST`` pins the result (probe
    skipped)."""
    pinned = _env_float("REPRO_SERVE_SPAN_FACTOR_HOST", 0.0)
    if pinned > 0:
        return pinned
    if len(groups) < 2:
        return 1.0
    devs = [_lane_device(g) for g in list(groups)[:2]]
    key = tuple(str(d) for d in devs) + ("host",)
    with _SPAN_FACTOR_LOCK:
        if key in _SPAN_FACTOR_CACHE:
            return _SPAN_FACTOR_CACHE[key]
        torch_lane = _torch_lane(devs[0])
        h = np.random.default_rng(0).random(1 << 16).astype(np.float32)

        def host_lane(iters):
            for _ in range(iters):
                np.sort(h, kind="stable")

        factor = _probe_pair(
            torch_lane, host_lane,
            lambda: (_iters_for(torch_lane), _iters_for(host_lane)))
        _SPAN_FACTOR_CACHE[key] = factor
        return factor


def measure_span_factors(groups: Sequence[DeviceGroup]
                         ) -> Dict[str, float]:
    """Per-workload-class contention factors: one probe per lane-class
    pair (``RequestSpec.lane_class``) instead of one global number."""
    return {"torch": measure_shared_span_factor(groups),
            "host": measure_host_span_factor(groups)}


@dataclass
class _Execution:
    """One unit of lane work: a single request or a coalesced batch."""
    requests: List[Request]
    specs: List[object]              # RequestSpec per request
    decision: PlacementDecision
    t_dispatch: float = 0.0
    est_span: float = 0.0
    hedge: bool = False              # duplicate launched by the watchdog
    # lanes whose _urgent count this execution holds (latency-class
    # deadline work: engines on these lanes yield until it runs)
    urgent_lanes: tuple = ()

    @property
    def n_units(self) -> int:
        return sum(max(int(s.total_units), 1) for s in self.specs)


class _Active:
    """One lane's currently running execution, as the watchdog sees it."""

    __slots__ = ("ex", "t0", "deadline", "requeued")

    def __init__(self, ex: _Execution, t0: float, deadline: float):
        self.ex = ex
        self.t0 = t0
        self.deadline = deadline
        self.requeued = False        # failover already requeued its work


class Scheduler:
    """Hybrid serving scheduler.  See module docstring.

    ``spec_factory(workload, payload) -> RequestSpec`` resolves
    payloads to executable specs; the default is the workload adapter
    registry in ``repro_torch.workloads.requests``.  ``policy`` is "cost"
    (placement arbitration) or "fifo" (benchmark baseline: every
    request dedicated to one fixed group, no batching, no sharing).
    ``failure_injector`` (``ft.failure.FailureInjector``) kills/revives
    groups at dispatch steps, for fault-path tests.  With no
    ``executor`` and no ``groups``, ``detect_platform(device=device)``
    builds the pair: ``device=None`` the GPU + CPU pair (raises without
    a GPU), ``device="cpu"`` the simulated pair on the CPU."""

    def __init__(self, groups: Optional[List[DeviceGroup]] = None,
                 executor: Optional[HybridExecutor] = None,
                 spec_factory: Optional[Callable] = None,
                 max_queue: Optional[int] = None,
                 batch_window_s: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 n_chunks: int = 8,
                 split_overhead_s: float = 0.0,
                 shared_span_factor: Optional[float] = None,
                 policy: str = "cost",
                 fifo_group: Optional[str] = None,
                 failure_injector=None,
                 explore_every: int = 16,
                 staleness_tau_s: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 exec_timeout_s: Optional[float] = None,
                 exec_timeout_k: float = 8.0,
                 hedge_delay_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 watchdog_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        if executor is not None:
            self._ex = executor
        else:
            if groups is None:
                groups, _ = detect_platform(device=device)
            self._ex = HybridExecutor(groups=groups, n_chunks=n_chunks)
        self.groups = self._ex.groups
        self._spec_factory = spec_factory
        self.clock = clock
        self.policy = policy
        self.fifo_group = fifo_group or self.groups[0].name
        self.split_overhead_s = split_overhead_s
        # measured cross-lane headroom pricing (2/concurrency_capacity
        # on contended hosts, 1.0 = perfect overlap).  It prices BOTH
        # the shared candidate's modeled makespan and the contention a
        # dedicated span pays while other lanes are busy.  None (the
        # default) self-probes it once at startup — trusting a
        # caller-supplied number meant every caller had to re-measure
        # overlap_check-style or silently inherit 1.0.
        if shared_span_factor is None:
            if policy == "cost" and len(self.groups) >= 2:
                # per-workload-class probes: host-native lanes (numpy
                # sort) overlap a torch lane near-perfectly even where
                # two torch lanes contend — one global factor would
                # price those co-schedules out of existence
                self.span_factors = {
                    k: max(float(v), 1e-9)
                    for k, v in measure_span_factors(self.groups).items()}
            else:
                self.span_factors = {"torch": 1.0, "host": 1.0}
            shared_span_factor = self.span_factors["torch"]
        else:
            # scalar caller override prices every class
            self.span_factors = {
                "torch": max(float(shared_span_factor), 1e-9),
                "host": max(float(shared_span_factor), 1e-9)}
        self.shared_span_factor = max(float(shared_span_factor), 1e-9)
        # staleness decay for placement estimates (age-weighted
        # shrinkage toward the cross-group mean, calibration.
        # get_decayed): heals stale lanes without exploration traffic
        if staleness_tau_s is None:
            staleness_tau_s = _env_float("REPRO_SERVE_STALE_TAU", 300.0)
        self.staleness_tau_s = max(float(staleness_tau_s), 0.0)
        if max_queue is None:
            max_queue = int(_env_float("REPRO_SERVE_QUEUE", 256))
        if batch_window_s is None:
            batch_window_s = _env_float("REPRO_SERVE_WINDOW_MS", 2.0) / 1e3
        if max_batch is None:
            max_batch = int(_env_float("REPRO_SERVE_MAX_BATCH", 8))
        self.batch_window_s = max(batch_window_s, 0.0)
        self.max_batch = max(int(max_batch), 1)
        self._queue = RequestQueue(max_queue, clock=clock)
        self.stats = ServeStats()
        # per-request lifecycle spans + projected-vs-actual placement
        # audit (repro_torch.obs): the recorder is the process singleton so
        # fleet workers ship one coherent batch per heartbeat
        self._rec = get_recorder()
        self.audit = PlacementAudit(clock=clock)
        self._injector = failure_injector
        self._step = 0
        # -- fault-tolerance knobs --------------------------------------
        if max_retries is None:
            max_retries = int(_env_float("REPRO_SERVE_MAX_RETRIES", 2))
        self.max_retries = max(int(max_retries), 0)
        if exec_timeout_s is None:
            exec_timeout_s = _env_float("REPRO_SERVE_EXEC_TIMEOUT_S", 30.0)
        self.exec_timeout_s = max(float(exec_timeout_s), 1e-3)
        self.exec_timeout_k = max(float(exec_timeout_k), 1.0)
        if hedge_delay_s is None:
            hedge_delay_s = _env_float("REPRO_SERVE_HEDGE_DELAY_S", 0.0)
        self.hedge_delay_s = max(float(hedge_delay_s), 0.0)  # 0 = p99
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = max(self.exec_timeout_s, 1.0)
        self.heartbeat_timeout_s = max(float(heartbeat_timeout_s), 1e-3)
        if watchdog_interval_s is None:
            watchdog_interval_s = max(
                0.005, min(self.exec_timeout_s / 4,
                           self.heartbeat_timeout_s / 4, 1.0))
            if self.hedge_delay_s > 0:
                watchdog_interval_s = min(watchdog_interval_s,
                                          max(self.hedge_delay_s / 4, 0.005))
        self.watchdog_interval_s = max(float(watchdog_interval_s), 0.001)
        self._hb_interval = max(min(self.heartbeat_timeout_s / 4, 0.25),
                                0.01)
        self._hb = HeartbeatMonitor([g.name for g in self.groups],
                                    timeout_s=self.heartbeat_timeout_s,
                                    clock=clock)
        self._active: Dict[str, _Active] = {}  # lane -> running execution
        self._suspect: set = set()             # lanes downed by watchdog
        # lanes with a dispatched-but-not-yet-running latency-class
        # deadline execution: continuous engines sharing the lane yield
        # at their next step boundary instead of re-grabbing the lock
        self._urgent: Dict[str, int] = {g.name: 0 for g in self.groups}
        self._wd_stop = threading.Event()
        # anti-starvation exploration: a lane whose cached estimate
        # says "slow" never gets traffic, so the estimate never heals —
        # a transient bad measurement (contention, GC pause, stale disk
        # entry) would starve the lane forever.  Every ``explore_every``
        # dispatches of a workload, a lane that hasn't executed it
        # since then gets one dedicated request to refresh its number.
        self.explore_every = max(int(explore_every), 0)
        self._wl_dispatches: Dict[str, int] = {}
        self._wl_last_exec: Dict[tuple, int] = {}

        self._lock = threading.Lock()          # stats + group loads
        self._idle = threading.Condition(self._lock)
        # continuous-batching engines, one per stepper instance, built
        # lazily on first routed request (lane assignment recorded in
        # ``engine_placements`` for observability / cold-start tests)
        self._engines: Dict[int, continuous.ContinuousEngine] = {}
        self._engines_lock = threading.Lock()
        self.engine_placements: Dict[str, object] = {}
        self._loads: Dict[str, GroupLoad] = {
            g.name: GroupLoad(g.name, None) for g in self.groups}
        self._group_locks = {g.name: threading.Lock() for g in self.groups}
        # a GPU group's dedicated lane launches on a stream of its own,
        # as the executor's group workers do (made by the lane worker)
        self._streams: Dict[str, object] = {}
        self._lanes: Dict[str, "queue.Queue"] = {
            g.name: queue.Queue() for g in self.groups}
        self._lanes[_SHARED_LANE] = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._started = False
        self._draining = False
        self._stopped = False
        _LIVE.add(self)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Scheduler":
        with self._lock:
            if self._started or self._stopped:
                return self
            self._started = True
        self._threads = [threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True)]
        for g in self.groups:
            self._threads.append(threading.Thread(
                target=self._group_worker, args=(g,),
                name=f"serve-{g.name}", daemon=True))
        self._threads.append(threading.Thread(
            target=self._shared_worker, name="serve-shared", daemon=True))
        self._threads.append(threading.Thread(
            target=self._watchdog_loop, name="serve-watchdog", daemon=True))
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admitting, run everything already accepted, resolve
        every in-flight future exactly once.  True when fully idle
        within ``timeout``."""
        with self._lock:
            self._draining = True
        self._queue.close()
        if not self._started:
            # nothing was ever dispatched; reject whatever queued
            self._reject_remaining("shutdown")
            return True
        deadline = None if timeout is None else self.clock() + timeout
        with self._idle:
            while True:
                if (len(self._queue) == 0 and self.stats.in_flight == 0
                        and all(q.empty() for q in self._lanes.values())):
                    return True
                wait = (None if deadline is None
                        else deadline - self.clock())
                if wait is not None and wait <= 0:
                    return False
                self._idle.wait(wait if wait is None or wait < 0.2
                                else 0.2)

    def shutdown(self, timeout: Optional[float] = 30.0,
                 abort: bool = False) -> None:
        """Drain (or abort: reject what never started) and join every
        scheduler thread."""
        with self._lock:
            if self._stopped:
                return
            self._draining = True
        self._queue.close()
        if abort:
            self._reject_remaining("shutdown")
        else:
            self.drain(timeout)
        with self._lock:
            self._stopped = True
        self._wd_stop.set()
        with self._engines_lock:
            engines = list(self._engines.values())
        for eng in engines:
            eng.shutdown(timeout=timeout if timeout is not None else 10.0)
        for lane in self._lanes.values():
            lane.put(None)
        # wake the dispatcher (close() already notified; idempotent)
        self._queue.close()
        for t in self._threads:
            t.join(timeout)
        self._threads = []

    def __enter__(self) -> "Scheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _reject_remaining(self, reason: str) -> None:
        for r in self._queue.drain_remaining():
            if r.reject(Rejection(reason, r.workload,
                                  detail="scheduler shut down")):
                self.stats.inc(rejected_shutdown=1)

    # -- submission -----------------------------------------------------
    def submit(self, workload: str, payload=None,
               deadline: Optional[float] = None,
               priority: int = 0, hedge: bool = False,
               trace_id: Optional[str] = None,
               slo_class: Optional[str] = None) -> ServeFuture:
        """Enqueue one request.  ``deadline`` is seconds from now; a
        request that cannot (or did not) finish in time resolves with a
        structured ``RequestRejected`` instead of hanging.  Never
        blocks: admission control answers immediately.

        ``hedge=True`` marks the request latency-sensitive: once its
        execution runs past the hedge delay the watchdog duplicates it
        on an idle lane and the first result wins.  ``slo_class``
        ("latency" | "batch" | "best_effort", default derived — see
        ``resolve_slo_class``) drives class-aware admission: latency
        work sheds on a projected deadline miss, batch work queues
        through pressure and sheds only under brownout WITH a deep
        queue, best-effort sheds at any
        brownout (a lane is down and the survivors are absorbing its
        load).  ``trace_id`` threads an upstream trace through (the
        fleet router's — a fresh one is minted when absent and tracing
        is on)."""
        self.start()
        slo = resolve_slo_class(slo_class, priority, deadline, hedge)
        rec = self._rec
        if trace_id is None and rec.enabled:
            trace_id = new_trace_id()
        now = self.clock()
        req = Request(workload=workload, payload=payload,
                      priority=priority, deadline_s=deadline,
                      t_submit=now,
                      t_deadline=None if deadline is None
                      else now + max(deadline, 0.0),
                      hedge=hedge, trace_id=trace_id, slo_class=slo)
        with self._lock:
            self.stats.inc(submitted=1)
            if self._draining or self._stopped:
                self.stats.inc(rejected_shutdown=1)
                req.reject(Rejection("shutdown", workload,
                                     detail="scheduler is draining"))
                return req.future
            if slo != SLO_LATENCY and self._brownout_locked():
                # brownout ordering by class: best-effort sheds at any
                # degradation; batch sheds only once the queue is past
                # half depth (a late batch result is still a result —
                # shed it only when backlog says capacity really is
                # gone); latency work always admits (its deadline
                # feasibility check governs instead)
                if (slo == SLO_BEST_EFFORT
                        or len(self._queue) > self._queue.max_depth // 2):
                    self.stats.inc(shed_brownout=1)
                    rec.instant("brownout", "fault", "sched", trace_id,
                                workload=workload, slo=slo)
                    req.reject(Rejection(
                        "brownout", workload,
                        detail=f"{slo} shed: a lane is down and "
                               "survivors are absorbing its load"))
                    return req.future
        try:
            spec = self._make_spec(workload, payload)
        except Exception as e:
            self.stats.inc(failed=1)
            req.future._reject(e)
            return req.future
        req.bucket = spec.bucket or workload
        req.n_units = max(int(spec.total_units), 1)
        req.payload = spec                      # dispatcher reads the spec
        rec.instant("submit", "request", "sched", trace_id,
                    workload=workload, req_id=req.req_id)
        req._t_q0 = rec.now()                   # queue_wait span start
        rej = self._queue.push(req)
        with self._lock:
            if rej is not None:
                self.stats.inc(rejected_full=1)
            self.stats.queue_depth.observe(len(self._queue))
        return req.future

    def _make_spec(self, workload: str, payload):
        if self._spec_factory is not None:
            return self._spec_factory(workload, payload)
        from repro_torch.workloads import requests as adapters
        return adapters.make_request(workload, payload)

    # -- dispatcher -----------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            req, shed = self._queue.pop(timeout=0.1)
            if shed:
                self.stats.inc(shed_deadline=len(shed))
                for r in shed:
                    self._rec.instant("shed", "request", "sched",
                                      r.trace_id, reason="deadline")
                with self._idle:
                    self._idle.notify_all()
            if req is None:
                if self._queue.closed and len(self._queue) == 0:
                    with self._lock:
                        stopped = self._stopped
                        in_flight = self.stats.in_flight
                    if stopped or in_flight <= 0:
                        return
                    # closed queue pops return immediately; executions
                    # are still in flight and a watchdog failover may
                    # yet requeue their requests — keep polling gently
                    # (once in_flight hits 0 no unresolved future is
                    # left, so no retry can ever arrive: safe to exit)
                    time.sleep(0.01)
                continue
            batch = [req]
            if self.policy == "cost" and self.max_batch > 1:
                batch += self._queue.pop_matching(
                    req.workload, req.bucket, self.max_batch - 1)
                # linger for the window ONLY while nothing else waits:
                # holding a non-matching request hostage to fill this
                # batch is head-of-line blocking (measured: a 2 ms
                # linger per cycle serialized dispatch into the p50 at
                # high arrival rates).  Engine-routed (stepper) specs
                # never linger — the engine batches at step boundaries,
                # so waiting here only delays their prefill.  Brownout
                # (a lane is down) also skips the linger: the batch
                # window was priced for full capacity
                if (len(batch) < self.max_batch
                        and self.batch_window_s > 0
                        and not self._queue.closed
                        and len(self._queue) == 0
                        and not self._brownout()
                        and not (continuous_enabled() and getattr(
                            req.payload, "stepper", None) is not None)):
                    time.sleep(self.batch_window_s)
                    batch += self._queue.pop_matching(
                        req.workload, req.bucket,
                        self.max_batch - len(batch))
            # a requeued request may have been resolved by its original
            # execution while it waited — dispatching it again would
            # only burn device time on a no-op resolve
            batch = [r for r in batch if not r.future.done()]
            if batch:
                self._dispatch(batch)

    def _apply_injection(self) -> None:
        inj = self._injector
        if inj is None:
            return
        if hasattr(inj, "at_step"):
            kill, revive = inj.at_step(self._step)
            if kill:
                self._lane_death(kill, "injected kill")
            if revive:
                self._lane_revive(revive)
        self._apply_time_injection()

    def _apply_time_injection(self) -> None:
        """Time-based (chaos) kills/revives: polled by the watchdog
        tick AND at each dispatch, so faults land even between ticks."""
        inj = self._injector
        if inj is None or not hasattr(inj, "at_time"):
            return
        kills, revives = inj.at_time(self.clock())
        for name in kills:
            self._lane_death(name, "injected kill")
        for name in revives:
            self._lane_revive(name)

    def _dispatch(self, batch: List[Request]) -> None:
        self._apply_injection()
        self._step += 1
        rec = self._rec
        if rec.enabled:
            t_pop = rec.now()
            for r in batch:
                rec.complete("queue_wait", "request",
                             getattr(r, "_t_q0", t_pop), t_pop, "sched",
                             r.trace_id, workload=r.workload)
        specs = [r.payload for r in batch]
        if (self.policy == "cost" and continuous_enabled()
                and getattr(specs[0], "stepper", None) is not None):
            self._dispatch_engine(batch)
            return
        n_units = sum(max(int(s.total_units), 1) for s in specs)
        now = self.clock()
        t_p0 = rec.now()

        with self._lock:
            loads = [GroupLoad(ld.name,
                               self._unit_time(specs[0], ld.name),
                               ld.busy_until, ld.alive)
                     for ld in self._loads.values()]
        if self.policy == "fifo":
            loads = [ld for ld in loads if ld.name == self.fifo_group]
        # contention pricing resolved per workload class: host-native
        # adapters (lane_class "host", e.g. numpy sort) overlap a torch
        # lane where two torch lanes may contend — the class factor is
        # what lets exactly those co-schedules through
        factor = self.span_factors.get(
            getattr(specs[0], "lane_class", "torch"),
            self.shared_span_factor)
        decision = plan_placement(
            n_units, loads, now,
            split_overhead_s=self.split_overhead_s,
            # a coalesced batch's units are whole requests — sharing
            # them is exactly co-scheduling, allowed; single tiny
            # requests may still prefer a dedicated lane on their own
            allow_shared=(self.policy == "cost" and len(loads) >= 2),
            shared_span_factor=factor,
            # the same measured headroom prices dedicated spans that
            # overlap other busy lanes (no-headroom hosts: two
            # "parallel" dedicated lanes are contention, not overlap)
            contention_factor=factor)
        if decision is None:
            # every lane is dead: a structured *rejection*, counted as
            # one (a Rejection delivered to the caller while `failed`
            # ticked up made the audited invariant's terms lie)
            for r in batch:
                if r.reject(Rejection("lane_failure", r.workload,
                                      detail="no alive device group")):
                    self.stats.inc(rejected_failure=1)
                    with self._idle:
                        self._idle.notify_all()
            return
        decision = self._maybe_explore(specs[0].workload, loads, decision,
                                       n_units, now)
        if rec.enabled:
            rec.complete(
                "placement", "request", t_p0, rec.now(), "sched",
                batch[0].trace_id, workload=specs[0].workload,
                kind=decision.kind, groups=list(decision.groups),
                est_exec_s=decision.est_exec_s,
                queued_behind_s=decision.queued_behind_s,
                n_batch=len(batch),
                alternatives={k: round(v, 6) for k, v
                              in decision.alternatives.items()})

        # deadline-based shedding at admission: LATENCY-class members
        # whose deadline the projected completion already misses are
        # rejected now.  Batch/best-effort work with a deadline queues
        # anyway (a late batch result is still a result; the pop-time
        # expired-deadline shed still applies once it truly passes).
        kept: List[Request] = []
        for r in batch:
            if (r.slo_class != SLO_LATENCY
                    or deadline_feasible(decision, now, r.t_deadline)):
                kept.append(r)
                continue
            if r.reject(Rejection(
                    "deadline", r.workload,
                    detail=f"projected finish +"
                           f"{decision.t_finish - now:.4f}s misses "
                           f"deadline {r.deadline_s:.4f}s",
                    deadline_s=r.deadline_s,
                    waited_s=now - r.t_submit)):
                self.stats.inc(shed_deadline=1)
                rec.instant("shed", "request", "sched", r.trace_id,
                            reason="projected_deadline_miss")
                with self._idle:
                    self._idle.notify_all()
        if not kept:
            return
        for r in kept:
            # projected span for the placement audit: resolve stamps
            # the measured service time against this
            self.audit.record(r.req_id, r.workload, decision.kind,
                              decision.est_exec_s, decision.alternatives)
            r.future.meta["queued_behind_s"] = decision.queued_behind_s
        ex = _Execution([r for r in kept], [r.payload for r in kept],
                        decision, t_dispatch=now,
                        est_span=decision.est_exec_s)
        if any(r.slo_class == SLO_LATENCY and r.t_deadline is not None
               for r in kept):
            # latency-class deadline work headed for these lanes:
            # engines stepping batch rows there yield at their next
            # iteration boundary instead of re-taking the lane lock
            ex.urgent_lanes = tuple(decision.groups)
        with self._lock:
            if len(kept) > 1:
                self.stats.inc(batches=1, batched_requests=len(kept))
            for name in ex.urgent_lanes:
                self._urgent[name] = self._urgent.get(name, 0) + 1
            for name in decision.groups:
                ld = self._loads[name]
                ld.busy_until = max(ld.busy_until, now) + ex.est_span
        wl = specs[0].workload
        n_disp = self._wl_dispatches.get(wl, 0) + 1
        self._wl_dispatches[wl] = n_disp
        for name in decision.groups:
            self._wl_last_exec[(wl, name)] = n_disp
        if decision.kind == SHARED:
            self._lanes[_SHARED_LANE].put(ex)
        else:
            self._lanes[decision.groups[0]].put(ex)

    def _maybe_explore(self, wl: str, loads, decision: PlacementDecision,
                       n_units: int, now: float) -> PlacementDecision:
        """Override a placement with a dedicated run on a starved lane
        (no execution of this workload in the last ``explore_every``
        dispatches): the measurement it produces replaces the stale
        estimate, at a bounded ~1/explore_every cost if the estimate
        turns out to be right after all."""
        if (self.policy != "cost" or self.explore_every <= 0
                or len(loads) < 2):
            return decision
        n_disp = self._wl_dispatches.get(wl, 0)
        if n_disp < self.explore_every:
            return decision
        for ld in loads:
            if not ld.alive or ld.name in decision.groups:
                continue
            if (n_disp - self._wl_last_exec.get((wl, ld.name), 0)
                    >= self.explore_every):
                start = max(now, ld.busy_until)
                span = n_units * (ld.unit_time or 0.0)
                return PlacementDecision(
                    "dedicated", [ld.name], start, start + span, span,
                    queued_behind_s=start - now,
                    alternatives=decision.alternatives)
        return decision

    # -- continuous-batching engine route -------------------------------
    def _dispatch_engine(self, batch: List[Request]) -> None:
        """Route stepper-backed requests to their continuous engine:
        no placement scoring per request (the engine's lanes were
        chosen once from CostTerms priors), no batching window (rows
        join the running batch at the next step boundary)."""
        now = self.clock()
        try:
            eng = self._engine_for(batch[0].payload.stepper)
        except BaseException as e:                 # noqa: BLE001
            for r in batch:
                self._engine_reject(r, e)
            return
        if eng is None:
            # a dead-lane window during engine routing must be a
            # structured rejection, not a dispatcher-crashing
            # RuntimeError that hangs every queued future
            for r in batch:
                if r.reject(Rejection(
                        "lane_failure", r.workload,
                        detail="no alive device group for engine")):
                    self.stats.inc(rejected_failure=1)
                    with self._idle:
                        self._idle.notify_all()
            return
        if len(batch) > 1:
            self.stats.inc(batches=1, batched_requests=len(batch))
        for r in batch:
            if not eng.submit(r, r.payload, now):
                if r.reject(Rejection("shutdown", r.workload,
                                      detail="engine shut down")):
                    self.stats.inc(rejected_shutdown=1)
                    with self._idle:
                        self._idle.notify_all()

    def _engine_for(self, stepper
                    ) -> Optional[continuous.ContinuousEngine]:
        """The (lazily built) engine for this stepper, or None when no
        alive lane exists to place it on (caller rejects)."""
        key = id(stepper)
        with self._engines_lock:
            eng = self._engines.get(key)
            if eng is not None:
                return eng
            plan = self._plan_engine_lanes(stepper)
            if plan is None:
                return None
            pre_g = next(g for g in self.groups
                         if g.name == plan.prefill_group)
            dec_g = next(g for g in self.groups
                         if g.name == plan.decode_group)

            def on_step(n_live):
                self.stats.inc(engine_steps=1)

            def on_join(k):
                self.stats.inc(engine_joins=k)

            def on_evict(k):
                self.stats.inc(engine_evictions=k)

            def on_cancel(k):
                self.stats.inc(engine_cancellations=k)

            def on_preempt(k):
                self.stats.inc(engine_preemptions=k)

            # lanes whose urgent (latency-class deadline) dispatches
            # pause this engine's batch stepping: everything its step
            # locks cover (all groups on a simulated platform — the
            # same set _lane_locks serializes)
            yield_lanes = (sorted(self._group_locks)
                           if getattr(self._ex, "simulated", False)
                           else [plan.decode_group])

            def should_yield():
                with self._lock:
                    return any(self._urgent.get(n, 0) > 0
                               for n in yield_lanes)

            eng = continuous.ContinuousEngine(
                stepper,
                resolve=self._resolve,
                reject=self._engine_reject,
                prefill_locks=self._lane_locks(plan.prefill_group),
                step_locks=self._lane_locks(plan.decode_group),
                prefill_group=plan.prefill_group,
                decode_group=plan.decode_group,
                prefill_ctx=lambda: self._device_ctx(pre_g),
                step_ctx=lambda: self._device_ctx(dec_g),
                should_yield=should_yield,
                hooks={"on_step": on_step, "on_join": on_join,
                       "on_evict": on_evict, "on_cancel": on_cancel,
                       "on_preempt": on_preempt},
                clock=self.clock)
            self._engines[key] = eng
            self.engine_placements[stepper.workload] = plan
            return eng

    def _plan_engine_lanes(self, stepper):
        """Phase-to-lane assignment from CostTerms priors only (no
        probes: a fresh process must place with last_probe_runs == 0).
        Prefill is compute-bound, decode bandwidth-bound — predict()
        rates them against each group's device profile, scaled by the
        group's slowdown.  None when no lane is alive (caller delivers
        a structured rejection)."""
        from repro_torch.core import cost_model
        with self._lock:
            loads = [GroupLoad(ld.name, None, ld.busy_until, ld.alive)
                     for ld in self._loads.values()]
        pre = {g.name: cost_model.predict(stepper.prefill_cost,
                                          _lane_device(g)) * g.slowdown
               for g in self.groups}
        dec = {g.name: cost_model.predict(stepper.decode_cost,
                                          _lane_device(g)) * g.slowdown
               for g in self.groups}
        return plan_disaggregation(loads, pre, dec)

    def _engine_reject(self, req: Request, exc: BaseException) -> None:
        if req.future._reject(exc):
            self.stats.inc(failed=1)
            with self._idle:
                self._idle.notify_all()

    def _unit_time(self, spec, group_name: str) -> Optional[float]:
        """sec/unit estimate for placement: calibration cache first
        (measured affinity, possibly from a previous process — decayed
        toward the cross-group mean as it goes stale, so a lane whose
        old "slow" number starved it of traffic drifts back to parity
        and re-measures itself without exploration), then the
        cost-model prior, else None (probe-only workloads fall back to
        symmetric placement until their first measured execution)."""
        g = next(g for g in self.groups if g.name == group_name)
        # peers = the OTHER *alive* lanes: after a failover the
        # survivors' recalibrated projections must not shrink toward a
        # dead lane's numbers (its entries were marked stale at death)
        cached = self._ex.cache.get_decayed(
            spec.workload, group_name, g.slowdown,
            peers=[(o.name, o.slowdown) for o in self.groups
                   if o.name != group_name
                   and self._loads[o.name].alive],
            tau_s=self.staleness_tau_s)
        if cached is not None:
            return cached
        uc = getattr(spec, "unit_cost", None)
        if isinstance(uc, dict):
            uc = uc.get(group_name)
        if uc is not None:
            from repro_torch.core import cost_model
            if cost_model.enabled():
                return cost_model.predict(uc, _lane_device(g)) * g.slowdown
        return None

    # -- lane workers ---------------------------------------------------
    def _lane_locks(self, name: Optional[str]) -> List[threading.Lock]:
        """Locks an execution must hold.  Shared executions (name None)
        take every group; so do *dedicated* executions on a simulated
        platform — the groups share one physical device there, and two
        'concurrent' lanes would just contend for the same cores (the
        1-device serving bench measured the scheduler losing to FIFO
        0.56x before this): placement still arbitrates order and
        batching, but execution honestly serializes.  Sorted order
        everywhere — no deadlock."""
        if name is None or getattr(self._ex, "simulated", False):
            return [self._group_locks[n] for n in sorted(self._group_locks)]
        return [self._group_locks[name]]

    def _group_worker(self, g: DeviceGroup) -> None:
        lane = self._lanes[g.name]
        while True:
            try:
                ex = lane.get(timeout=self._hb_interval)
            except queue.Empty:
                self._hb.beat(g.name)      # idle-but-alive heartbeat
                # a suspect lane whose worker is back in its idle loop
                # is demonstrably responsive again: rejoin
                self._maybe_rejoin(g.name)
                continue
            if ex is None:
                return
            self._hb.beat(g.name)
            locks = self._lane_locks(g.name)
            for lk in locks:
                lk.acquire()
            try:
                self._lane_run(g.name, ex,
                               lambda: self._run_dedicated(ex, g))
            finally:
                for lk in reversed(locks):
                    lk.release()
            self._hb.beat(g.name)
            self._maybe_rejoin(g.name)

    def _shared_worker(self) -> None:
        lane = self._lanes[_SHARED_LANE]
        while True:
            try:
                ex = lane.get(timeout=self._hb_interval)
            except queue.Empty:
                continue
            if ex is None:
                return
            locks = self._lane_locks(None)
            for lk in locks:
                lk.acquire()
            try:
                self._lane_run(_SHARED_LANE, ex,
                               lambda: self._run_shared(ex))
            finally:
                for lk in reversed(locks):
                    lk.release()

    def _lane_run(self, lane_name: str, ex: _Execution,
                  fn: Callable[[], None]) -> None:
        """Run one execution with the watchdog watching: registered in
        the active table with its deadline (``k × est_span``, floored
        at ``exec_timeout_s``) for the duration."""
        t0 = self.clock()
        deadline = t0 + max(self.exec_timeout_k * max(ex.est_span, 0.0),
                            self.exec_timeout_s)
        act = _Active(ex, t0, deadline)
        # the lane locks are held here: the urgent work has its lane,
        # engines may resume stepping at the next lock handoff
        self._mark_urgent_done(ex)
        with self._lock:
            self._active[lane_name] = act
        try:
            fn()
        finally:
            with self._lock:
                self._active.pop(lane_name, None)

    def _mark_urgent_done(self, ex: _Execution) -> None:
        """Release the lanes' urgent counts this execution holds
        (idempotent: requeue paths and normal execution both call)."""
        lanes, ex.urgent_lanes = ex.urgent_lanes, ()
        if not lanes:
            return
        with self._lock:
            for name in lanes:
                self._urgent[name] = max(self._urgent.get(name, 0) - 1, 0)

    def _maybe_rejoin(self, name: str) -> None:
        """A watchdog-suspected lane whose stuck execution finally
        completed is wedged no more: flip it back alive (its requeued
        work already ran elsewhere; resolve-exactly-once absorbed the
        duplicates) and let exploration re-measure it."""
        with self._idle:
            if name not in self._suspect:
                return
            self._suspect.discard(name)
            ld = self._loads.get(name)
            if ld is not None and not ld.alive:
                ld.alive = True
                self.stats.inc(lane_revivals=1)
                self._rec.instant("lane_revive", "fault", f"lane:{name}",
                                  why="suspect lane responsive again")
                self._idle.notify_all()

    def _device_ctx(self, g: DeviceGroup):
        """Run under the group's device: the lane device every adapter
        reads, and on a GPU the lane's own stream (made on first use)."""
        dev = primary_device(g)
        stream = None
        if dev is not None and dev.type == "cuda":
            with self._lock:
                stream = self._streams.get(g.name)
                if stream is None:
                    stream = self._streams[g.name] = torch.cuda.Stream(dev)
        return device_ctx(g, stream)

    def _shed_expired(self, ex: _Execution) -> List[int]:
        """Last-chance deadline check at execution start; returns kept
        member indices."""
        now = self.clock()
        kept = []
        for i, r in enumerate(ex.requests):
            if r.t_deadline is not None and now > r.t_deadline:
                if r.reject(Rejection(
                        "deadline", r.workload,
                        detail=f"deadline {r.deadline_s:.4f}s passed in "
                               f"lane queue",
                        deadline_s=r.deadline_s,
                        waited_s=now - r.t_submit)):
                    self.stats.inc(shed_deadline=1)
                    self._rec.instant("shed", "request", "sched",
                                      r.trace_id, reason="lane_queue")
                    with self._idle:
                        self._idle.notify_all()
            else:
                kept.append(i)
        return kept

    def _merge_batch(self, ex: _Execution, kept: List[int]):
        """Array-level batching: when every kept member's adapter has a
        ``merge`` hook, stack the payloads into ONE execution (returns
        the ``MergedBatch``, or None -> request-granularity path).  A
        merge that declines (mismatched shapes within a pow2 bucket)
        or raises falls back — batching is an optimization, never a
        correctness risk."""
        if len(kept) < 2:
            return None
        specs = [ex.specs[i] for i in kept]
        merge = getattr(specs[0], "merge", None)
        if merge is None or any(getattr(s, "merge", None) is not merge
                                for s in specs):
            return None
        try:
            merged = merge(specs)
        except Exception:                          # noqa: BLE001
            return None
        if merged is not None:
            self.stats.inc(merged_batches=1)
        return merged

    def _run_dedicated(self, ex: _Execution, g: DeviceGroup) -> None:
        kept = self._shed_expired(ex)
        t0 = self.clock()
        done_units = 0
        # merged executions calibrate under the merged spec's workload
        # key: its units (whole member requests) can differ from the
        # base spec's units (e.g. sort segments)
        cal_wl = ex.specs[0].workload
        faults = self._lane_faults([g.name])
        rec = self._rec
        track = f"lane:{g.name}"
        try:
            with self._device_ctx(g):
                self._fault_pre(faults)
                t_m0 = rec.now()
                merged = self._merge_batch(ex, kept)
                if merged is not None:
                    rec.complete("merge", "exec", t_m0, rec.now(), track,
                                 ex.requests[kept[0]].trace_id,
                                 n=len(kept), workload=cal_wl)
                    cal_wl = merged.spec.workload
                    ts = self.clock()
                    t_e0 = rec.now()
                    value = merged.spec.run_one()
                    t_e1 = rec.now()
                    done_units += max(int(merged.spec.total_units), 1)
                    rec.complete("lane_exec", "exec", t_e0, t_e1, track,
                                 ex.requests[kept[0]].trace_id,
                                 workload=cal_wl, merged=True,
                                 n=len(kept))
                    t_d0 = rec.now()
                    for j, i in enumerate(kept):
                        self._stamp_lane(ex.requests[i], g, merged=True)
                        self._resolve(ex.requests[i],
                                      merged.demux(value, j), ts,
                                      hedge=ex.hedge)
                    rec.complete("demux", "exec", t_d0, rec.now(), track,
                                 ex.requests[kept[0]].trace_id,
                                 n=len(kept))
                    kept = []
                for i in kept:
                    r, spec = ex.requests[i], ex.specs[i]
                    ts = self.clock()
                    t_e0 = rec.now()
                    value = spec.run_one()
                    t_e1 = rec.now()
                    done_units += max(int(spec.total_units), 1)
                    rec.complete("lane_exec", "exec", t_e0, t_e1, track,
                                 r.trace_id, workload=r.workload,
                                 hedge=ex.hedge)
                    self._stamp_lane(r, g)
                    self._resolve(r, value, ts, hedge=ex.hedge)
            # an injected slowdown stretches elapsed (below) so the
            # slowed time is what calibration learns — survivors'
            # projections recalibrate to the lane's real state
            self._fault_post(faults, self.clock() - t0)
        except BaseException as e:                 # noqa: BLE001
            self._fail_or_retry(ex, kept, e,
                                lane_dead=not self._lane_alive(g.name),
                                detail=f"lane {g.name}: {e}")
        elapsed = self.clock() - t0
        if done_units > 0 and elapsed > 0:
            self._ex.cache.put(cal_wl, g.name,
                               elapsed * g.slowdown / done_units,
                               g.slowdown)
        self._finish_lane([g.name], ex, elapsed, dedicated=True)

    @staticmethod
    def _stamp_lane(r: Request, g: Optional[DeviceGroup],
                    merged: bool = False) -> None:
        """Where the request ran, for clients: the group (``"shared"``
        for a work-shared execution) and its device, written before the
        future resolves (a late duplicate leaves the winner's stamp)."""
        if r.future.done():
            return
        r.future.meta["lane"] = g.name if g is not None else "shared"
        if g is not None:
            r.future.meta["device"] = str(_lane_device(g))
        r.future.meta["merged"] = merged

    def _run_shared(self, ex: _Execution) -> None:
        kept = self._shed_expired(ex)
        if not kept:
            self._finish_lane([g.name for g in self.groups], ex, 0.0,
                              dedicated=False, count=False)
            return
        t0 = self.clock()
        faults = self._lane_faults([g.name for g in self.groups])
        rec = self._rec
        for i in kept:
            self._stamp_lane(ex.requests[i], None)
        try:
            self._fault_pre(faults)
            # the shares run on their groups' devices; the merge
            # (combine) gathers on the first group's
            with device_ctx(self.groups[0]):
                if len(kept) == 1:
                    r = ex.requests[kept[0]]
                    spec = ex.specs[kept[0]]
                    t_e0 = rec.now()
                    value = self._run_shared_single(spec)
                    rec.complete("lane_exec", "exec", t_e0, rec.now(),
                                 "lane:shared", r.trace_id,
                                 workload=r.workload, shared=True)
                    self._resolve(r, value, t0)
                else:
                    self._run_shared_batch(ex, kept, t0)
            self._fault_post(faults, self.clock() - t0)
        except BaseException as e:                 # noqa: BLE001
            any_dead = any(not self._lane_alive(g.name)
                           for g in self.groups)
            self._fail_or_retry(ex, kept, e, lane_dead=any_dead,
                                detail=f"shared execution: {e}")
        self._finish_lane([g.name for g in self.groups], ex,
                          self.clock() - t0, dedicated=False)

    def _run_shared_single(self, spec):
        ex = self._ex
        ex.calibrate(lambda g, k: spec.run_share(g, 0, k),
                     probe_units=max(spec.total_units // 8, 1),
                     workload=spec.workload,
                     unit_cost=getattr(spec, "unit_cost", None))
        self.stats.inc(probe_runs=ex.last_probe_runs)
        out = ex.run_work_shared(
            spec.workload, spec.total_units, spec.run_share,
            spec.combine, comm_cost=spec.comm_cost,
            whole_shares=spec.whole_shares)
        return out.value

    def _run_shared_batch(self, ex: _Execution, kept: List[int],
                          t0: float) -> None:
        """Coalesced execution: the batch members ARE the work units —
        the work-share splits whole requests across the groups (each
        member runs entirely on one group: exact per-request demux, no
        cross-request state), amortizing planning, lane arbitration and
        dispatch over the window.  Array-level merging is deliberately
        NOT used here: a shared placement happens on idle lanes, where
        running members concurrently across lanes beats fusing them
        into one kernel on one lane — and per-member executions reuse
        the members' own jit caches, while a stacked grid's chunk
        slices would compile fresh shapes inside the serving path."""
        specs = [ex.specs[i] for i in kept]
        spec0 = specs[0]
        key = f"{spec0.workload}@batch"

        def run_share(group, start, k):
            return [specs[j].run_one() for j in range(start, start + k)]

        def combine(outs):
            return [v for part in outs for v in part]

        uc = getattr(spec0, "unit_cost", None)
        uc = _scale_unit_cost(uc, max(int(spec0.total_units), 1))
        hx = self._ex
        # probe=False + warmup=False: a batch member must execute
        # exactly once — probes/warmup would re-run requests (members
        # are whole requests, not re-executable slices of one)
        hx.calibrate(lambda g, k: run_share(g, 0, k), probe_units=1,
                     workload=key, unit_cost=uc, probe=False)
        rec = self._rec
        t_e0 = rec.now()
        # min_units=1: every live group keeps measuring its own batch
        # throughput (a stale slow estimate must not starve a lane out
        # of the split it would need to correct itself)
        out = hx.run_work_shared(key, len(specs), run_share, combine,
                                 comm_cost=spec0.comm_cost, warmup=False,
                                 min_units=1)
        rec.complete("lane_exec", "exec", t_e0, rec.now(), "lane:shared",
                     ex.requests[kept[0]].trace_id, workload=key,
                     shared=True, n=len(kept))
        t_d0 = rec.now()
        for j, i in enumerate(kept):
            self._resolve(ex.requests[i], out.value[j], t0)
        rec.complete("demux", "exec", t_d0, rec.now(), "lane:shared",
                     ex.requests[kept[0]].trace_id, n=len(kept))

    def _resolve(self, req: Request, value, t_start: float,
                 hedge: bool = False) -> None:
        now = self.clock()
        if req.future._resolve(value):
            # the actual span the placement audit compares against the
            # decision's projection (no-op for ids it never recorded)
            self.audit.stamp(req.req_id, now - t_start)
            self._rec.instant("resolve", "request", "sched",
                              req.trace_id, workload=req.workload,
                              service_s=now - t_start, hedge=hedge)
            self.stats.inc(completed=1, hedge_wins=1 if hedge else 0)
            with self._idle:
                self.stats.wait_s.observe(t_start - req.t_submit)
                self.stats.service_s.observe(now - t_start)
                self.stats.service_q.observe(now - t_start)
                self.stats.latency_s.observe(now - req.t_submit)
                self._idle.notify_all()

    # -- fault tolerance ------------------------------------------------
    def _lane_alive(self, name: str) -> bool:
        with self._lock:
            ld = self._loads.get(name)
            return ld.alive if ld is not None else True

    def _brownout_locked(self) -> bool:
        return degraded_fraction(list(self._loads.values())) > 0.0

    def _brownout(self) -> bool:
        with self._lock:
            return self._brownout_locked()

    def _fail_or_retry(self, ex: _Execution, kept: List[int],
                       e: BaseException, lane_dead: bool,
                       detail: str) -> None:
        """Execution-failure policy: a ``LaneFailure`` (or any error on
        a lane already marked dead) requeues the unresolved members
        within their retry budget — adapters are pure, so re-execution
        is safe.  Application errors reject the future as before: they
        would fail identically anywhere."""
        retryable = isinstance(e, LaneFailure) or lane_dead
        for i in kept:
            r = ex.requests[i]
            if r.future.done():
                continue
            if retryable:
                self._requeue(r, detail)
            elif r.future._reject(e):
                self.stats.inc(failed=1)
                with self._idle:
                    self._idle.notify_all()

    def _requeue(self, r: Request, why: str) -> None:
        """Re-admit a lane-failed request (exactly-once: the caller
        checked the future is unresolved; a racing original resolve
        just turns the retry into a no-op)."""
        with self._idle:
            if self._stopped:
                if r.reject(Rejection("shutdown", r.workload,
                                      detail=f"not retried ({why}): "
                                             "scheduler stopped")):
                    self.stats.inc(rejected_shutdown=1)
                    self._idle.notify_all()
                return
            if r.retries >= self.max_retries:
                if r.reject(Rejection(
                        "lane_failure", r.workload,
                        detail=f"retry budget ({self.max_retries}) "
                               f"exhausted: {why}")):
                    self.stats.inc(rejected_failure=1)
                    self._idle.notify_all()
                return
            r.retries += 1
            self.stats.inc(retries=1)
        self._rec.instant("requeue", "fault", "sched", r.trace_id,
                          workload=r.workload, retry=r.retries, why=why)
        r._t_q0 = self._rec.now()               # fresh queue_wait span
        rej = self._queue.push(r, requeue=True)
        if rej is not None:
            self.stats.inc(rejected_full=1)
            with self._idle:
                self._idle.notify_all()

    def _lane_death(self, name: str, why: str,
                    watchdog: bool = False) -> None:
        """Failover: mark the lane dead, requeue its in-flight and
        lane-queued work onto the survivors, mark its calibration
        entries stale (revival re-measures instead of trusting
        pre-death numbers)."""
        to_requeue: List[Request] = []
        with self._idle:
            ld = self._loads.get(name)
            if ld is None:
                return
            if not ld.alive:
                if not watchdog:
                    return  # chaos kill of an already-dead lane: no-op
            else:
                ld.alive = False
                self.stats.inc(lane_deaths=1, failovers=1,
                               watchdog_timeouts=1 if watchdog else 0)
                if watchdog:
                    self._suspect.add(name)
                self._rec.instant(
                    "watchdog_kill" if watchdog else "lane_death",
                    "fault", f"lane:{name}", why=why)
                self._idle.notify_all()
            act = self._active.get(name)
            if act is not None and not act.requeued:
                act.requeued = True
                to_requeue.extend(act.ex.requests)
        # drain executions still queued behind the dead lane — they
        # would otherwise wait on a lane that may never run again
        lane_q = self._lanes.get(name)
        if lane_q is not None:
            while True:
                try:
                    ex = lane_q.get_nowait()
                except queue.Empty:
                    break
                if ex is None:            # shutdown sentinel: keep it
                    lane_q.put(None)
                    break
                to_requeue.extend(ex.requests)
                self._mark_urgent_done(ex)   # it will redispatch fresh
                with self._lock:
                    ld = self._loads[name]
                    ld.busy_until = max(ld.busy_until - ex.est_span,
                                        self.clock())
        self._ex.cache.mark_group_stale(name)
        for r in to_requeue:
            if not r.future.done():
                self._requeue(r, why)

    def _lane_revive(self, name: str) -> None:
        with self._idle:
            ld = self._loads.get(name)
            if ld is None or ld.alive:
                return
            ld.alive = True
            self._suspect.discard(name)
            self.stats.inc(lane_revivals=1)
            self._rec.instant("lane_revive", "fault", f"lane:{name}",
                              why="injected revive")
            self._idle.notify_all()

    def _watchdog_loop(self) -> None:
        while not self._wd_stop.wait(self.watchdog_interval_s):
            try:
                self._watchdog_tick()
            except Exception:                      # noqa: BLE001
                # the robustness layer must not die on a shutdown race
                pass

    def _watchdog_tick(self) -> None:
        now = self.clock()
        self._apply_time_injection()
        # 1. execution deadlines: k x est_span (floor exec_timeout_s)
        with self._lock:
            expired = [(lane, act) for lane, act in self._active.items()
                       if not act.requeued and now > act.deadline]
        for lane, act in expired:
            if lane == _SHARED_LANE:
                self._shared_timeout(act)
            elif self._lane_alive(lane):
                self._lane_death(
                    lane,
                    f"execution exceeded {act.deadline - act.t0:.3f}s "
                    f"watchdog deadline", watchdog=True)
        # 2. heartbeats: an idle lane that stopped beating has a wedged
        # worker (a lane busy in a long legitimate execution is governed
        # by its exec deadline instead — no false positives)
        for name in self._hb.check():
            with self._lock:
                ld = self._loads.get(name)
                busy = name in self._active
            if ld is None or not ld.alive or busy:
                continue
            self._lane_death(name, "missed heartbeats", watchdog=True)
        # 3. hedging: duplicate slow latency-sensitive requests
        self._hedge_tick(now)

    def _shared_timeout(self, act: _Active) -> None:
        """A timed-out shared execution has no single lane to kill —
        requeue its unresolved members (they will re-plan, likely onto
        dedicated lanes) and leave the stuck run to finish or lose."""
        with self._idle:
            if act.requeued:
                return
            act.requeued = True
            self.stats.inc(watchdog_timeouts=1, failovers=1)
            self._rec.instant("watchdog_kill", "fault", "lane:shared",
                              why="shared execution timed out")
            self._idle.notify_all()
        for r in act.ex.requests:
            if not r.future.done():
                self._requeue(r, "shared execution timed out")

    def _hedge_delay(self) -> Optional[float]:
        if self.hedge_delay_s > 0:
            return self.hedge_delay_s
        if self.stats.service_q.n < 8:
            return None                 # not enough tail signal yet
        return self.stats.service_q.quantile(0.99)

    def _hedge_tick(self, now: float) -> None:
        delay = self._hedge_delay()
        if delay is None:
            return
        launches: List[tuple] = []
        with self._lock:
            for lane, act in self._active.items():
                if lane == _SHARED_LANE or act.ex.hedge:
                    continue
                if now - act.t0 < delay:
                    continue
                for idx, r in enumerate(act.ex.requests):
                    if (not r.hedge or r.hedged or r.future.done()):
                        continue
                    tgt = None
                    for name, ld in self._loads.items():
                        if (name == lane or not ld.alive
                                or name in self._active
                                or not self._lanes[name].empty()):
                            continue
                        tgt = name
                        break
                    if tgt is None:
                        continue        # no idle lane: hedge later
                    r.hedged = True
                    self.stats.inc(hedges=1)
                    self._rec.instant("hedge", "fault", f"lane:{tgt}",
                                      r.trace_id, workload=r.workload,
                                      original_lane=lane)
                    est = max(act.ex.est_span, 0.0)
                    dec = PlacementDecision(
                        "dedicated", [tgt], now, now + est, est)
                    hx = _Execution([r], [act.ex.specs[idx]], dec,
                                    t_dispatch=now, est_span=est,
                                    hedge=True)
                    self._loads[tgt].busy_until = (
                        max(self._loads[tgt].busy_until, now) + est)
                    launches.append((tgt, hx))
        for tgt, hx in launches:
            self._lanes[tgt].put(hx)

    def _lane_faults(self, names: Sequence[str]) -> List[object]:
        """Chaos-injector execution-level faults active on these lanes
        right now (empty without a time-based injector)."""
        inj = self._injector
        if inj is None or not hasattr(inj, "exec_fault"):
            return []
        now = self.clock()
        return [f for f in (inj.exec_fault(n, now) for n in names)
                if f is not None]

    def _fault_pre(self, faults: Sequence[object]) -> None:
        for f in faults:
            self._rec.instant("chaos_fault", "fault", f"lane:{f.lane}",
                              kind=f.kind)
            if f.kind == "hang":
                time.sleep(f.duration_s)
            elif f.kind in ("kill", "flaky"):
                raise LaneFailure(f"injected {f.kind} on lane {f.lane}")

    @staticmethod
    def _fault_post(faults: Sequence[object], elapsed: float) -> None:
        slow = max([f.factor for f in faults if f.kind == "slow"],
                   default=1.0)
        if slow > 1.0 and elapsed > 0:
            time.sleep((slow - 1.0) * elapsed)

    def _finish_lane(self, names: Sequence[str], ex: _Execution,
                     elapsed: float, dedicated: bool,
                     count: bool = True) -> None:
        now = self.clock()
        if count and elapsed > 0:
            # utilization accounting: the elapsed span was busy time on
            # every lane the execution held (shared runs hold them all)
            for name in names:
                self.audit.lane_busy(name, elapsed)
        with self._idle:
            if count:
                self.stats.inc(dedicated=1 if dedicated else 0,
                               shared=0 if dedicated else 1)
            for name in names:
                ld = self._loads[name]
                # replace this execution's estimated span with reality;
                # estimates for work still queued behind it stay in
                ld.busy_until = max(ld.busy_until - ex.est_span, now)
            self._idle.notify_all()


def _scale_unit_cost(uc, k: int):
    """Scale a per-unit CostTerms (or per-group dict of them) to a
    whole-request cost — the unit of a coalesced batch execution."""
    if uc is None:
        return None
    if isinstance(uc, dict):
        return {g: _scale_unit_cost(t, k) for g, t in uc.items()}
    from repro_torch.core.cost_model import CostTerms
    return CostTerms(flops=uc.flops * k, bytes=uc.bytes * k,
                     steps=max(uc.steps, 1), compute=uc.compute,
                     host_bytes=uc.host_bytes * k,
                     interpret_steps=uc.interpret_steps)
