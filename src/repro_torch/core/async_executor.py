"""Chunk-pipelined asynchronous execution with work stealing.

The paper's overlap thesis (makespan = max(t_fast, t_slow) + comm, not
sum(times)) only holds when the device groups actually run
*concurrently*.  This module provides that concurrency in two modes:

``threads``
    One worker thread per device group.  A GPU group's worker makes its
    device current and launches on a dedicated ``torch.cuda.Stream``
    (CUDA launches are asynchronous); it synchronises that stream after
    each chunk (required to clock the chunk for the work-stealing
    scheduler) while the other groups' compute proceeds.  A CPU group's
    worker runs PyTorch's CPU operators, which release the interpreter
    lock while they compute.  The join across groups is the thread
    join, so the measured wall-clock span is the *real* overlap
    makespan.  Used when the groups own disjoint devices (the GPU and
    the CPU of one host).

``virtual``
    Discrete-event simulation with one virtual clock per group: the
    group whose clock is lowest executes its next chunk (serially, on
    the one physical device), and its clock advances by the measured
    (slowdown-scaled) or modeled chunk time.  Steal decisions see the
    same clocks a real concurrent run would, so the schedule — and the
    reported makespan — is exactly the paper's overlap model, while
    every chunk still executes exactly once.

Work stealing replaces the one-shot static split: the shares are cut
into uniform chunks, each group owns a contiguous run of chunks, and a
group that drains its queue steals from the *tail* of the group with
the latest estimated finish time (the chunks its owner would reach
last).  A steal happens only when the thief's projected finish with the
chunk beats the victim's projected finish without help, so a
well-calibrated plan is left alone and a mis-calibrated (or straggling)
one self-corrects within a single call instead of only across calls via
``refine_split``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import lane_device

_EPS = 1e-9


@dataclass(frozen=True)
class Chunk:
    """A contiguous run of work units; the unit meaning is the caller's
    (rows, nonzeros, bins, micro-batches, ...)."""
    seq: int                  # position in unit order (combine order)
    start: int                # first work unit
    units: int
    owner: str                # group the static plan assigned it to


@dataclass
class ChunkRecord:
    chunk: Chunk
    group: str                # group that actually executed it
    t_start: float            # seconds since call start (virtual or wall)
    t_end: float
    stolen: bool


@dataclass
class ExecutionTrace:
    """Everything a caller needs to merge outputs and account time."""
    outputs: List[object]            # one per chunk, in seq (unit) order
    chunks: List[Chunk]              # same order as outputs
    records: List[ChunkRecord]       # execution order
    group_busy: Dict[str, float]     # per-group sum of chunk times
    group_end: Dict[str, float]      # per-group last completion time
    group_units: Dict[str, int]      # per-group units actually executed
    makespan: float                  # max(group_end) — no comm/merge
    steals: int
    n_chunks: int
    mode: str                        # "threads" | "virtual" | "sequential"
    # monotonic wall clock at call start: lets observers (the tracing
    # layer) re-anchor the records' call-relative t_start/t_end onto a
    # shared timeline.  "threads" records are wall-relative; "virtual"
    # records carry simulated clocks — still anchored here, flagged by
    # ``mode`` so a viewer knows the span positions are modeled.
    t_base: float = 0.0


def make_chunks(units_per_group: Sequence[int], group_names: Sequence[str],
                chunk_units: int) -> Dict[str, List[Chunk]]:
    """Cut the work into a *fixed* global chunk grid, then hand each
    group a contiguous run of whole chunks matching its planned share.

    The grid depends only on (total_units, chunk_units), never on the
    plan: chunk shapes are identical call after call, so whatever a
    chunk shape warms (allocations, library algorithm choices) stays
    warm even as the EWMA plan drifts.  Chunks stay globally contiguous (group i+1 starts where
    group i ends) so order-sensitive combiners (row concatenation)
    keep working; shares are rounded to the nearest chunk boundary."""
    chunk_units = max(int(chunk_units), 1)
    total = int(sum(units_per_group))
    grid: List[Tuple[int, int]] = []
    s = 0
    while s < total:
        grid.append((s, min(chunk_units, total - s)))
        s += chunk_units
    queues: Dict[str, List[Chunk]] = {n: [] for n in group_names}
    cum = 0.0
    lo_idx = 0
    for name, share in zip(group_names, units_per_group):
        cum += share
        hi_idx = min(int(round(cum / chunk_units)), len(grid))
        for i in range(lo_idx, hi_idx):
            start, k = grid[i]
            queues[name].append(Chunk(i, start, k, name))
        lo_idx = hi_idx
    # rounding may leave grid tail unassigned: give it to the last
    # group with any planned share
    if lo_idx < len(grid):
        tail_owner = [n for n, u in zip(group_names, units_per_group)
                      if u > 0][-1]
        for i in range(lo_idx, len(grid)):
            start, k = grid[i]
            queues[tail_owner].append(Chunk(i, start, k, tail_owner))
    return queues


def make_share_chunks(units_per_group: Sequence[int],
                      group_names: Sequence[str]) -> Dict[str, List[Chunk]]:
    """One chunk per group, exactly the planned share.  For
    suitability-split workloads (spmv's ELL-head / COO-tail) whose
    per-chunk shapes are data-dependent: a uniform grid would make
    every chunk a fresh shape (and a fresh packing), so the share
    executes as a single chunk and shape stability comes from the
    sticky plan instead of the fixed grid."""
    queues: Dict[str, List[Chunk]] = {}
    s = 0
    for i, (name, k) in enumerate(zip(group_names, units_per_group)):
        queues[name] = [Chunk(i, s, int(k), name)] if k > 0 else []
        s += int(k)
    return queues


def primary_device(group) -> Optional[torch.device]:
    devs = getattr(group, "devices", None)
    return torch.device(devs[0]) if devs else None


@contextmanager
def device_ctx(group, stream: Optional["torch.cuda.Stream"] = None):
    """Run under the group's primary device: it becomes the thread's
    lane device (``kernels.common.lane_device``); for a GPU also the
    current device and ``stream`` (when given) its current stream."""
    dev = primary_device(group)
    if dev is None:
        yield
        return
    with lane_device(dev):
        if dev.type != "cuda":
            yield
            return
        with torch.cuda.device(dev):
            if stream is None:
                yield
            else:
                with torch.cuda.stream(stream):
                    yield


class WorkStealingScheduler:
    """Thread-safe per-group chunk deques with steal-from-tail."""

    def __init__(self, queues: Dict[str, List[Chunk]],
                 steal: bool = True):
        self._lock = threading.Lock()
        self._queues: Dict[str, deque] = {g: deque(q)
                                          for g, q in queues.items()}
        self.steal_enabled = steal
        self.steals = 0

    def remaining_units(self, group: str) -> int:
        return sum(c.units for c in self._queues[group])

    def total_remaining(self) -> int:
        with self._lock:
            return sum(c.units for q in self._queues.values() for c in q)

    def next_chunk(self, thief: str, clocks: Dict[str, float],
                   unit_time: Dict[str, float],
                   can_steal: bool = True
                   ) -> Optional[Tuple[Chunk, bool]]:
        """Pop the thief's own next chunk, else steal from the tail of
        the group with the latest estimated finish — but only when the
        steal is projected to beat the victim finishing it alone.
        ``can_steal=False`` blocks stealing for this thief (e.g. it has
        no measured chunk time yet, so its projection is untrusted)."""
        with self._lock:
            own = self._queues.get(thief)
            if own:
                return own.popleft(), False
            if not self.steal_enabled or not can_steal:
                return None
            best = None
            for victim, q in self._queues.items():
                if victim == thief or not q:
                    continue
                victim_finish = (clocks[victim] + self.remaining_units(victim)
                                 * unit_time.get(victim, 1.0))
                if best is None or victim_finish > best[1]:
                    best = (victim, victim_finish)
            if best is None:
                return None
            victim, victim_finish = best
            chunk = self._queues[victim][-1]
            thief_finish = (clocks[thief]
                            + chunk.units * unit_time.get(thief, 1.0))
            if thief_finish >= victim_finish - _EPS:
                return None                 # stealing wouldn't help
            self._queues[victim].pop()
            self.steals += 1
            return chunk, True


class _UnitTimeEstimate:
    """Online per-group seconds/unit EWMA used for steal decisions.

    ``trusted`` names groups whose prior came from real calibration (a
    cache hit or a hardware-model prediction) rather than the blind 1.0
    default: their projections are steal-worthy before they have timed
    a single chunk of their own this call."""

    def __init__(self, groups: Sequence[str],
                 priors: Optional[Dict[str, float]] = None,
                 alpha: float = 0.5,
                 trusted: Optional[Sequence[str]] = None):
        self.alpha = alpha
        self.est: Dict[str, float] = {
            g: max((priors or {}).get(g, 1.0), _EPS) for g in groups}
        self.n_obs: Dict[str, int] = {g: 0 for g in groups}
        self.trusted = set(trusted or ())
        self._lock = threading.Lock()

    def update(self, group: str, units: int, elapsed: float) -> None:
        if units <= 0:
            return
        per_unit = max(elapsed / units, _EPS)
        with self._lock:
            self.est[group] = (self.alpha * per_unit
                               + (1 - self.alpha) * self.est[group])
            self.n_obs[group] += 1

    def observed(self, group: str) -> bool:
        with self._lock:
            return (self.n_obs.get(group, 0) > 0
                    or group in self.trusted)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.est)


class AsyncChunkExecutor:
    """Concurrent chunk executor over device groups.

    ``run_chunk(group_name, start_unit, n_units) -> output`` executes
    one chunk and blocks until its result is ready (workloads
    synchronise their own device internally; CPU operators are
    naturally blocking).  Each chunk is executed exactly once —
    stealing moves a chunk between queues, it never duplicates it.
    """

    def __init__(self, groups, steal: bool = True,
                 time_model: Optional[Callable[[str, int], float]] = None):
        self.groups = list(groups)
        self.steal = steal
        self.time_model = time_model

    # ------------------------------------------------------------------
    def run(self, units_per_group: Sequence[int],
            run_chunk: Callable[[str, int, int], object],
            chunk_units: int, mode: str,
            unit_time_priors: Optional[Dict[str, float]] = None,
            whole_shares: bool = False,
            trusted_priors: Optional[Sequence[str]] = None
            ) -> ExecutionTrace:
        """Execute the planned shares concurrently.  ``mode`` is
        "threads", "virtual", or "sequential" (the no-overlap baseline:
        same chunks, same order, one serial loop).  ``whole_shares``
        executes each group's share as a single chunk (suitability
        splits with data-dependent chunk shapes; implies no stealing).
        ``trusted_priors`` lists groups whose ``unit_time_priors`` come
        from calibration or the hardware cost model — they may steal
        before timing a chunk of their own this call."""
        active = [(g, k) for g, k in zip(self.groups, units_per_group)
                  if k > 0]
        names = [g.name for g, _ in active]
        if whole_shares:
            queues = make_share_chunks([k for _, k in active], names)
        else:
            queues = make_chunks([k for _, k in active], names, chunk_units)
        sched = WorkStealingScheduler(
            queues, steal=(self.steal and mode != "sequential"
                           and not whole_shares))
        est = _UnitTimeEstimate(names, unit_time_priors,
                                trusted=trusted_priors)
        n_chunks = sum(len(q) for q in queues.values())
        records: List[ChunkRecord] = []
        outputs: Dict[int, object] = {}
        rec_lock = threading.Lock()
        clocks: Dict[str, float] = {n: 0.0 for n in names}
        busy: Dict[str, float] = {n: 0.0 for n in names}
        units_done: Dict[str, int] = {n: 0 for n in names}
        t_base = time.monotonic()

        def account(group: str, chunk: Chunk, out: object, t0: float,
                    dt: float, stolen: bool) -> None:
            with rec_lock:
                outputs[chunk.seq] = out
                busy[group] += dt
                units_done[group] += chunk.units
                records.append(ChunkRecord(chunk, group, t0, t0 + dt,
                                           stolen))

        if mode == "threads":
            self._run_threads(active, sched, est, run_chunk, account,
                              clocks)
        elif mode == "sequential":
            self._run_sequential(active, sched, run_chunk, account, clocks)
        else:
            self._run_virtual(active, sched, est, run_chunk, account,
                              clocks)

        ordered = sorted(outputs)
        chunks_by_seq = {r.chunk.seq: r.chunk for r in records}
        # makespan from chunk *completions* — an idle group re-checking
        # the queues (parked clock) must not extend the span
        group_end = {n: 0.0 for n in names}
        for r in records:
            group_end[r.group] = max(group_end[r.group], r.t_end)
        makespan = max(group_end.values()) if group_end else 0.0
        return ExecutionTrace(
            outputs=[outputs[s] for s in ordered],
            chunks=[chunks_by_seq[s] for s in ordered],
            records=records, group_busy=busy, group_end=group_end,
            group_units=units_done, makespan=makespan,
            steals=sched.steals, n_chunks=n_chunks, mode=mode,
            t_base=t_base)

    # ------------------------------------------------------------------
    def _chunk_time(self, group, chunk, raw_elapsed: float) -> float:
        if self.time_model is not None:
            return self.time_model(group.name, chunk.units)
        return raw_elapsed * getattr(group, "slowdown", 1.0)

    def _run_virtual(self, active, sched, est, run_chunk, account,
                     clocks) -> None:
        """Discrete-event loop: the group with the lowest virtual clock
        executes next, so the interleaving matches a concurrent run."""
        live = {g.name: g for g, _ in active}
        while live:
            name = min(live, key=lambda n: clocks[n])
            g = live[name]
            got = sched.next_chunk(name, clocks, est.snapshot(),
                                   can_steal=est.observed(name))
            if got is None:
                # Drained and no profitable steal *right now*.  If other
                # queues still hold work, park this group just past the
                # earliest busy clock and re-evaluate (the owner may yet
                # degrade); otherwise it is done.  A group with no
                # measured chunk of its own can never steal — done.
                busy_clocks = [clocks[n] for n in live if n != name
                               and sched.remaining_units(n) > 0]
                if (sched.steal_enabled and busy_clocks
                        and est.observed(name)):
                    clocks[name] = max(clocks[name],
                                       min(busy_clocks) + _EPS)
                    continue
                del live[name]
                continue
            chunk, stolen = got
            t0 = time.perf_counter()
            with device_ctx(g):
                out = run_chunk(name, chunk.start, chunk.units)
            dt = self._chunk_time(g, chunk, time.perf_counter() - t0)
            account(name, chunk, out, clocks[name], dt, stolen)
            est.update(name, chunk.units, dt)
            clocks[name] += dt

    def _run_threads(self, active, sched, est, run_chunk, account,
                     clocks) -> None:
        """One worker per group, pinned to the group's primary device;
        a GPU group launches on its own stream and synchronises it per
        chunk.  Clocks are wall time since the common start."""
        t_origin = time.perf_counter()
        errors: List[BaseException] = []

        def worker(g):
            name = g.name
            dev = primary_device(g)
            stream = (torch.cuda.Stream(dev)
                      if dev is not None and dev.type == "cuda" else None)
            try:
                with device_ctx(g, stream):
                    while True:
                        now = time.perf_counter() - t_origin
                        wall = {n: now for n in clocks}
                        got = sched.next_chunk(
                            name, wall, est.snapshot(),
                            can_steal=est.observed(name))
                        if got is None:
                            if (sched.steal_enabled
                                    and est.observed(name)
                                    and sched.total_remaining() > 0):
                                time.sleep(0.001)   # owner may yet straggle
                                continue
                            break
                        chunk, stolen = got
                        t0 = time.perf_counter()
                        out = run_chunk(name, chunk.start, chunk.units)
                        if stream is not None:
                            stream.synchronize()
                        t1 = time.perf_counter()
                        dt = t1 - t0
                        account(name, chunk, out, t0 - t_origin, dt,
                                stolen)
                        est.update(name, chunk.units, dt)
                        clocks[name] = t1 - t_origin
            except BaseException as e:      # noqa: BLE001 — re-raised at join
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(g,),
                                    name=f"hybrid-{g.name}")
                   for g, _ in active]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _run_sequential(self, active, sched, run_chunk, account,
                        clocks) -> None:
        """No-overlap baseline: every group's chunks in one serial loop;
        the 'makespan' is the sum of all chunk times (what the seed's
        Python for-loop actually delivered on real hardware)."""
        t_cursor = 0.0
        for g, _ in active:
            name = g.name
            while True:
                got = sched.next_chunk(name, clocks, {})
                if got is None:
                    break
                chunk, stolen = got
                t0 = time.perf_counter()
                with device_ctx(g):
                    out = run_chunk(name, chunk.start, chunk.units)
                dt = self._chunk_time(g, chunk, time.perf_counter() - t0)
                account(name, chunk, out, t_cursor, dt, stolen)
                t_cursor += dt
                clocks[name] = t_cursor
