"""Hybrid executor: chunk-pipelined work sharing over device groups.

Execution model
---------------
A work-shared call is planned (throughput-proportional integer shares,
paper §5.4.3), cut into uniform chunks, and handed to the
``AsyncChunkExecutor``:

* **Real overlap** — on a host with a CUDA GPU the ``accel`` group is
  the GPU and the ``host`` group the CPU (the paper's CPU+GPU pair).
  Each group gets a worker thread pinned to its device (the GPU's with
  a stream of its own) and the groups compute concurrently; the
  reported makespan is the real wall-clock span of the joined threads.
* **Simulated overlap** — on a single device (the CPU, when the caller
  asks for it explicitly, or the GPU under ``force_simulated``) the
  groups share the hardware, so
  concurrency is simulated with per-group virtual clocks: chunks
  interleave in virtual-time order, the slower group's chunk
  times are scaled by its ``slowdown`` factor, and the makespan is the
  paper's overlap model max(t_fast, t_slow) + comm.  Every result
  records which mode produced it (``HybridResult.mode`` and
  ``WorkSharedOutput.simulated``).

Within one call a group that drains its chunk queue *steals* from the
tail of the slowest group's queue, so a mis-calibrated split (or a
mid-run straggler) self-corrects without waiting for the next call's
``refine_split``.  Calibration is remembered process-wide per
(workload, group, slowdown) in the ``CalibrationCache``: the first call
for a workload probes once per group and warms the chunk shapes; every
steady-state call after that executes each chunk exactly once.

Both the measured makespan and the analytic model makespan
(``WorkPlan.hybrid_time``) are reported side by side so the overlap
benchmarks can show how far reality is from the model.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import work_sharing
from repro_torch.core.async_executor import (AsyncChunkExecutor,
                                             ExecutionTrace, device_ctx,
                                             make_chunks, make_share_chunks,
                                             primary_device)
from repro_torch.core.calibration import (ThroughputTracker,
                                          get_calibration_cache, measure)
from repro_torch.core.metrics import HybridResult
from repro_torch.kernels.common import sync
from repro_torch.obs import get_recorder

# torch.profiler markers of a work-shared call's timed windows: the
# chunk run (makespan) and the merge
TIMED_RUN = "hybrid:timed_run"
TIMED_MERGE = "hybrid:timed_merge"


@dataclass
class DeviceGroup:
    name: str
    devices: List[torch.device]
    device_class: str                # "accel" | "host"
    slowdown: float = 1.0            # simulated relative slowdown (>=1)


def detect_platform(simulated_ratio: float = 4.0, device=None,
                    force_simulated: bool = False
                    ) -> Tuple[List[DeviceGroup], bool]:
    """Build device groups.

    ``device`` names the accel group's device; ``None`` means the first
    CUDA GPU, and raises when there is none.  A GPU accel device ->
    ``accel`` on the GPU, ``host`` on the CPU (real heterogeneity, the
    paper's pair).  An explicit CPU accel device -> simulate a hybrid
    pair on the CPU with the given throughput ratio (Hybrid-Low's
    GPU:CPU sustained ratio 77.7/20 ~= 3.9 is the default).

    ``force_simulated`` always builds the simulated pair on the accel
    device, the GPU included — benchmarks that sweep throughput ratios
    (table2's Hybrid-High vs -Low) need the ratio honored on a host
    whose real pair would otherwise replace it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "detect_platform: no CUDA device; pass device='cpu' to "
                "simulate the hybrid pair on the CPU")
        accel = torch.device("cuda", 0)
    else:
        accel = torch.device(device)
    if force_simulated or accel.type == "cpu":
        return ([DeviceGroup("accel", [accel], "accel", slowdown=1.0),
                 DeviceGroup("host", [accel], "host",
                             slowdown=simulated_ratio)], True)
    return ([DeviceGroup("accel", [accel], "accel"),
             DeviceGroup("host", [torch.device("cpu")], "host")], False)


def _assigned_units(units: Sequence[int], names: Sequence[str],
                    chunk_units: int) -> List[int]:
    """Units per group after rounding shares to whole chunks — what the
    executor will actually run, which the analytic model must predict."""
    active = [(n, k) for n, k in zip(names, units) if k > 0]
    if not active:
        return [0] * len(names)
    queues = make_chunks([k for _, k in active], [n for n, _ in active],
                         chunk_units)
    per = {n: sum(c.units for c in q) for n, q in queues.items()}
    return [per.get(n, 0) for n in names]


@dataclass(frozen=True)
class UnitPlan:
    """The plan of a call with no chunk trace (a task graph, lbm's plane
    split): the units each group was given, in group order."""
    units: List[int]


@dataclass
class WorkSharedOutput:
    value: object
    result: HybridResult
    plan: Union[work_sharing.WorkPlan, UnitPlan]
    simulated: bool
    trace: Optional[ExecutionTrace] = None


def untraced_output(ex: "HybridExecutor", workload: str, hybrid_time: float,
                    single: Dict[str, float], busy: Dict[str, float],
                    value: object, units: Sequence[int]) -> WorkSharedOutput:
    """The output of a call that times its own phases instead of running
    the executor's chunks."""
    return WorkSharedOutput(
        value, HybridResult(workload, hybrid_time, single, busy),
        UnitPlan([int(u) for u in units]), ex.simulated)


def scheduled_output(ex: "HybridExecutor", workload: str, sched,
                     single: Dict[str, float], value: object,
                     units: Sequence[int]) -> WorkSharedOutput:
    """The output of a task-graph call: the schedule's makespan is its
    hybrid time and each device is busy for its non-idle share of it."""
    busy = {d: (1 - f) * sched.makespan for d, f in sched.idle_frac.items()}
    return untraced_output(ex, workload, sched.makespan, single, busy,
                           value, units)


class HybridExecutor:
    """Work-sharing executor over two (or more) device groups.

    ``run_share(group_name, start_unit, n_units)`` must execute one
    chunk and block until its output is ready (synchronise the group's
    device before returning).

    With no ``groups``, ``detect_platform`` builds them: the GPU and
    the CPU, or — when ``device="cpu"`` or ``force_simulated`` — the
    simulated pair.  ``steal=False`` turns work stealing off for every
    call (a call with a ``plan_override`` never steals).
    ``time_model(group_name, units) -> seconds``, when given, replaces
    the measured chunk times and runs every call in virtual-clock mode
    (reproducible heterogeneity on one device)."""

    def __init__(self, groups: Optional[List[DeviceGroup]] = None,
                 simulated_ratio: float = 4.0, n_chunks: int = 16,
                 steal: bool = True, device=None,
                 force_simulated: bool = False,
                 time_model: Optional[Callable[[str, int], float]] = None):
        if groups is None:
            groups, sim = detect_platform(simulated_ratio, device,
                                          force_simulated)
            self.simulated = sim
        else:
            devs = [str(d) for g in groups for d in g.devices]
            self.simulated = len(set(devs)) < len(devs)
        self.groups = groups
        self.n_chunks = max(int(n_chunks), 1)
        self.steal = bool(steal)
        self.time_model = time_model
        self.tracker = ThroughputTracker([g.name for g in groups])
        # persisted entries are keyed by platform: a GPU pair never
        # shares unit times with a CPU-simulated pair, nor with the
        # simulated pair on the GPU, whose ``host`` group is the GPU (at
        # a ratio of 1.0 its keys would otherwise be the real host's)
        on_gpu = any(torch.device(d).type == "cuda"
                     for g in groups for d in g.devices)
        self.backend = ("torch:cpu" if not on_gpu
                        else "torch:cuda:simulated" if self.simulated
                        else "torch:cuda")
        self.cache = get_calibration_cache(self.backend)
        self._cache_key: Optional[str] = None
        self._warm = False
        # probe executions paid by the last calibrate() (0 = every
        # group seeded from the cache or the model)
        self.last_probe_runs = 0
        # the serving scheduler shares ONE executor between concurrent
        # worker threads: calibrate/run_work_shared mutate the tracker
        # and the warm state, so a work-shared call holds this lock end
        # to end (re-entrant: calibrate inside a locked call)
        self._call_lock = threading.RLock()

    # ------------------------------------------------------------------
    def calibrate(self, fn: Callable[[str, int], object], probe_units: int,
                  workload: Optional[str] = None, unit_cost=None,
                  probe: bool = True) -> None:
        """Seed per-group throughput for a workload (paper §4.5).

        On a cache hit for every group the probe runs are skipped
        entirely — the cached seconds/unit are installed; the cache is
        disk-persistent, so a *fresh process* also plans its first call
        with zero probe runs.  Compile warmup is tracked separately:
        only entries measured in this process suppress it (a disk hit
        calibrates the plan, but this process has not yet built the
        kernels, allocated the buffers or chosen the library algorithms
        of the chunk shapes).

        ``unit_cost`` (a ``core.cost_model.CostTerms`` describing ONE
        work unit, or a per-group-name dict of them for workloads whose
        groups run *different algorithms* — spmv's ELL head vs COO
        tail) supplies a model-predicted prior on a cache miss, so
        even a first-ever call plans without probes; the model's guess
        is never persisted — the first real chunks overwrite it with
        measurements.  On a miss without ``unit_cost`` (or with the
        model disabled) each group runs the probe twice (one warmup so
        a first-use kernel build or allocation never distorts the
        measurement), *under the group's pinned device context*, so
        each group warms its own device.
        ``last_probe_runs`` reports how many groups probed (0 = fully
        cache/model seeded: a fresh process's zero-probe first call).

        ``probe=False`` forbids probe runs (the serving scheduler's
        batched executions, where ``fn`` would re-execute a member
        request): a group with neither a cache entry nor a model prior
        is left unseeded — the plan starts symmetric and work stealing
        absorbs the error within the first call.
        """
        with self._call_lock:
            self.tracker.reset()
            self._cache_key = workload
            probe_units = max(int(probe_units), 1)
            warm = True
            self.last_probe_runs = 0
            for g in self.groups:
                cached = (self.cache.get(workload, g.name, g.slowdown)
                          if workload else None)
                if cached is not None:
                    self.tracker.seed(g.name, cached)
                    warm = warm and self.cache.warmed_in_process(
                        workload, g.name, g.slowdown)
                    continue
                warm = False
                uc = (unit_cost.get(g.name)
                      if isinstance(unit_cost, dict) else unit_cost)
                if uc is not None:
                    from repro_torch.core import cost_model
                    if cost_model.enabled():
                        dev = primary_device(g) or torch.device("cpu")
                        t_unit = cost_model.predict(uc, dev) * g.slowdown
                        self.tracker.seed(g.name, t_unit)
                        continue
                if not probe:
                    continue
                with device_ctx(g):
                    t = measure(lambda: fn(g.name, probe_units), warmup=1,
                                iters=1)
                self.last_probe_runs += 1
                t *= g.slowdown
                self.tracker.update(g.name, probe_units, t)
                if workload:
                    self.cache.put(workload, g.name, t / probe_units,
                                   g.slowdown)
            self._warm = warm
            self.tracker.mark_planned()

    def plan(self, total_units: int, comm_cost: float = 0.0,
             min_units: int = 0) -> work_sharing.WorkPlan:
        thr = self.tracker.throughputs([g.name for g in self.groups])
        return work_sharing.plan_work(total_units, thr, comm_cost,
                                      min_units=min_units)

    # ------------------------------------------------------------------
    def _mode(self) -> str:
        if self.time_model is not None or self.simulated:
            return "virtual"
        return "threads"

    def run_work_shared(self, workload: str, total_units: int,
                        run_share: Callable[[str, int, int], object],
                        combine: Callable[[Sequence[object]], object],
                        comm_cost: float = 0.0,
                        warmup: bool = True,
                        plan_override: Optional[Sequence[int]] = None,
                        sequential: bool = False,
                        whole_shares: bool = False,
                        min_units: int = 0) -> WorkSharedOutput:
        """Execute one work-shared computation, chunk-pipelined.

        run_share(group_name, start_unit, n_units) -> share output
        combine(outputs) -> final value (outputs arrive in unit order)
        warmup: allow the untimed warmup chunks (one per chunk shape
        and group) that the first call after a cold calibration runs;
        False when every unit must execute exactly once.
        plan_override: force this exact unit split (benchmark sweeps);
        also disables stealing so the forced split is honored.
        sequential: run the no-overlap baseline loop instead (each
        chunk still executes exactly once).
        whole_shares: execute each group's share as ONE chunk (implies
        no stealing) — for suitability splits whose per-chunk shapes
        are data-dependent, where a uniform chunk grid would make
        every chunk a fresh packing in the timed path.
        min_units: floor every live group's share (the serving
        scheduler's batched executions pass 1, so a group with a stale
        slow estimate keeps measuring — and correcting — itself).

        Thread-safe: the whole call holds the executor's re-entrant
        call lock, so the serving scheduler can share one executor
        between its workers."""
        with self._call_lock:
            return self._run_work_shared_locked(
                workload, total_units, run_share, combine, comm_cost,
                warmup, plan_override, sequential, whole_shares, min_units)

    def _run_work_shared_locked(self, workload, total_units, run_share,
                                combine, comm_cost, warmup, plan_override,
                                sequential, whole_shares,
                                min_units) -> WorkSharedOutput:
        cache_key = self._cache_key or workload
        plan = self.plan(total_units, comm_cost, min_units=min_units)
        chunk_units = max(total_units // self.n_chunks, 1)
        names = [g.name for g in self.groups]
        if plan_override is not None:
            units = list(plan_override)
            if sum(units) != total_units:
                raise ValueError(f"plan_override {units} does not cover "
                                 f"the {total_units} units")
        else:
            # chunk-rounded shares, damped against call-to-call drift so
            # chunk->group assignment (and chunk shapes) stay stable;
            # plans are per platform: the same workload on a different
            # slowdown profile must not reuse or damp against this
            # platform's chunk assignment
            plan_key = cache_key + "|" + ",".join(
                f"{g.name}:{g.slowdown:g}" for g in self.groups)
            assigned0 = ([int(u) for u in plan.units] if whole_shares
                         else _assigned_units(plan.units, names,
                                              chunk_units))
            units = self.cache.sticky_plan(
                plan_key, total_units, chunk_units, assigned0)
        do_warmup = warmup and not self._warm

        mode = "sequential" if sequential else self._mode()
        steal = self.steal and plan_override is None
        # what the scheduler will actually allow (mirrors
        # AsyncChunkExecutor.run)
        eff_steal = steal and mode != "sequential" and not whole_shares

        if do_warmup:
            # warm the chunk shapes each group will actually execute:
            # one representative per (units, at-lo-boundary,
            # at-hi-boundary) signature — boundary chunks see
            # halo-clamped shapes, the grid tail may be a short chunk,
            # and suitability-split groups (spmv) must not be warmed on
            # ranges the other path owns.  Each group warms *under its
            # device context*, so first-use costs (kernel build, the
            # caching allocator's growth) land on the device that will
            # pay them.  With stealing on, every group warms the whole
            # grid's signatures — a stolen boundary chunk must not pay
            # them mid-run either.
            active = [(n_, k) for n_, k in zip(names, units) if k > 0]
            total_assigned = sum(k for _, k in active)
            if whole_shares:
                queues = make_share_chunks([k for _, k in active],
                                           [n_ for n_, _ in active])
            else:
                queues = make_chunks([k for _, k in active],
                                     [n_ for n_, _ in active], chunk_units)
            all_chunks = [c for q in queues.values() for c in q]
            by_name = {g.name: g for g in self.groups}
            warmed = set()
            for name, q in queues.items():
                g = by_name[name]
                dev = primary_device(g)
                chunks = all_chunks if eff_steal else q
                with device_ctx(g):
                    for c in chunks:
                        end = c.start + c.units
                        # near-boundary flags: halo workloads clamp the
                        # SECOND and PENULTIMATE chunks too (a halo that
                        # reaches past the grid edge), so those shapes
                        # get their own warmup representative
                        sig = (str(dev),
                               c.units, c.start == 0,
                               c.start <= chunk_units,
                               end == total_assigned,
                               total_assigned - end <= chunk_units)
                        if sig in warmed:
                            continue
                        warmed.add(sig)
                        sync(run_share(name, c.start, c.units))

        thr = self.tracker.throughputs(names)
        priors = {g.name: (1.0 / t if t > 0 else 1.0)
                  for g, t in zip(self.groups, thr)}
        # groups with a calibrated/model-seeded unit time carry a
        # trustworthy projection: they may steal before timing a
        # chunk of their own this call (cold first calls included)
        trusted = [g.name for g in self.groups
                   if self.tracker.stats[g.name].n_obs > 0]
        # the timed windows carry torch.profiler markers, so a profile of
        # the call can tell them from its set-up and warmup
        with torch.profiler.record_function(TIMED_RUN):
            trace = AsyncChunkExecutor(
                self.groups, steal=steal, time_model=self.time_model).run(
                units, run_share, chunk_units, mode,
                unit_time_priors=priors, whole_shares=whole_shares,
                trusted_priors=trusted)
        self._trace_chunks(workload, trace)

        if do_warmup:
            combine(list(trace.outputs))     # warm the merge path too
        with torch.profiler.record_function(TIMED_MERGE):
            t0 = time.perf_counter()
            value = combine(list(trace.outputs))
            merge_t = time.perf_counter() - t0

        # measured makespan: concurrent span + un-hidden comm + merge
        hybrid_time = trace.makespan + comm_cost + merge_t
        # analytic model of the *chunked* assignment (shares round to
        # whole chunks, so the ideal fractional plan would under- or
        # over-state the slow group's span)
        assigned = (list(units) if whole_shares else
                    _assigned_units(units, names, chunk_units))
        thr_now = self.tracker.throughputs(names)
        spans = [u / t for u, t in zip(assigned, thr_now) if t > 0]
        n_active = sum(1 for u in assigned if u > 0)
        analytic = (max(spans) if spans else 0.0) + (
            comm_cost if n_active > 1 else 0.0)
        # the same model with THIS run's observed per-unit times — the
        # paper's overlap structure (max, not sum) minus EWMA staleness
        # and machine-speed drift; groups that executed nothing fall
        # back to the EWMA estimate
        spans_obs = []
        for g, u, t in zip(self.groups, assigned, thr_now):
            if u <= 0:
                continue
            done_u = trace.group_units.get(g.name, 0)
            if done_u > 0:
                spans_obs.append(u * trace.group_busy[g.name] / done_u)
            elif t > 0:
                spans_obs.append(u / t)
        analytic_obs = (max(spans_obs) if spans_obs else 0.0) + (
            comm_cost + merge_t if n_active > 1 else merge_t)
        for g in self.groups:
            n_done = trace.group_units.get(g.name, 0)
            if n_done > 0:
                self.tracker.update(g.name, n_done,
                                    trace.group_busy[g.name])
                if cache_key:
                    self.cache.put(cache_key, g.name,
                                   trace.group_busy[g.name] / n_done,
                                   g.slowdown)
        # single-device-alone times from calibrated throughput
        single = {}
        for g in self.groups:
            thr = self.tracker.throughputs([g.name])[0]
            single[g.name] = total_units / thr if thr > 0 else float("inf")
        busy = {g.name: trace.group_busy.get(g.name, 0.0)
                for g in self.groups}
        res = HybridResult(workload, hybrid_time, single, busy,
                           analytic_time=analytic,
                           steals=trace.steals, n_chunks=trace.n_chunks,
                           mode=trace.mode,
                           analytic_observed_time=analytic_obs)
        return WorkSharedOutput(value, res, plan, self.simulated, trace)

    @staticmethod
    def _trace_chunks(workload: str, trace: ExecutionTrace) -> None:
        """Per-chunk spans + steal instants for the tracing layer.

        Emitted post-hoc from the execution records (no per-chunk hook
        in the hot worker loop): records carry call-relative times, so
        ``trace.t_base`` re-anchors them onto the recorder's monotonic
        timeline.  Virtual-mode spans are positioned by the simulated
        clocks — flagged in args so a viewer knows they are modeled."""
        rec = get_recorder()
        if not rec.enabled or not trace.records:
            return
        for r in trace.records:
            track = f"hybrid:{r.group}"
            rec.complete("chunk", "exec", trace.t_base + r.t_start,
                         trace.t_base + r.t_end, track,
                         workload=workload, units=r.chunk.units,
                         seq=r.chunk.seq, owner=r.chunk.owner,
                         stolen=r.stolen, mode=trace.mode)
            if r.stolen:
                rec.instant("steal", "exec", track, workload=workload,
                            seq=r.chunk.seq, owner=r.chunk.owner)
