"""Front-tier router: consistent-hash placement over K scheduler workers.

One scheduler process is a pool of device lanes; a *fleet* is K of them
behind this router.  Placement keys on **(workload, shape-bucket)** —
exactly the unit of warm state (a worker's memoized inputs on each
device, tuned configs, merged stack shapes, the caching allocator's
blocks) that a cold worker pays to rebuild — so repeat traffic for a
shape always lands on the worker that already holds it.  The hash
ring (md5, ``vnodes`` virtual nodes per worker — md5, not
``hash()``, because Python salts ``hash()`` per process and a router
restart must not reshuffle every key) gives two properties the affinity
argument needs:

* **stability** — the same key maps to the same worker across router
  instances and restarts;
* **minimal disruption** — when a worker dies, only *its* key range
  re-hashes onto the survivors (each key falls to the next alive owner
  clockwise on the ring); every other key keeps its warm worker.

Workers share the merge-on-write calibration/tune ``JsonStore``s, so
the survivor that inherits a dead worker's keys — or a cold worker
joining the fleet — places them with zero probe runs off the shared
store (the fleet bench gates ``last_probe_runs == 0`` on a cold join).

Worker lifecycle (heartbeats reuse ``ft.failure.HeartbeatMonitor``;
load reports reuse ``ServeStats.snapshot()``):

    alive ──missed beats > timeout──> suspect ──2x timeout──> dead
      ^                                  │                      │
      └──────── heartbeat resumes (rejoin) ◄────────────────────┘

``suspect`` stops receiving *new* traffic but keeps its in-flight
requests (a long GC pause must not duplicate work); ``dead`` (or a
transport-level death: the child process exited, the pipe broke)
re-hashes the key range AND re-submits the worker's unresolved requests
onto survivors under the scheduler's retry-budget/exactly-once
contract: each resubmit burns budget, budget exhaustion is a structured
``Rejection("worker_failure")``, never a hang, and a late completion
from a revived worker is a counted no-op (``duplicate_results``).

**Spill-on-hot**: when the affinity worker's live backlog exceeds
``REPRO_FLEET_SPILL_DEPTH`` and another alive worker is at most half as
loaded, the request reroutes to the ring's next owner — paying one cold
first use beats queueing behind a backlog.  **Brownout**: while any
worker is not alive, best-effort submissions (``priority < 0``) shed
with ``Rejection("brownout")`` at the router, before any transport.

Env knobs: ``REPRO_FLEET_VNODES`` (ring virtual nodes/worker, 64),
``REPRO_FLEET_MAX_RETRIES`` (resubmit budget, 2),
``REPRO_FLEET_HB_TIMEOUT_S`` (suspect threshold; dead at 2x, 5),
``REPRO_FLEET_SPILL_DEPTH`` (backlog that triggers spill, 8),
``REPRO_FLEET_HB_S`` (worker heartbeat interval, 1).
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.metrics import FleetStats
from repro_torch.ft.failure import HeartbeatMonitor
from repro_torch.obs import get_recorder, new_trace_id
from repro_torch.serve.request_queue import (Rejection, RequestRejected,
                                       ServeFuture)
from repro_torch.serve.transport import SubmitMsg, _env_float

_LIVE: "weakref.WeakSet[Router]" = weakref.WeakSet()


def shutdown_all(timeout: float = 10.0) -> None:
    """Stop every live router (test teardown hook)."""
    for r in list(_LIVE):
        try:
            r.shutdown(timeout=timeout)
        except Exception:
            pass


def default_bucket(payload) -> str:
    """Canonical payload projection used as the shape-bucket half of the
    placement key.  Registry payloads are small JSON-able dicts whose
    values determine the array shapes, so the canonical dump IS the
    shape bucket; callers with seed-varying payloads pass an explicit
    ``bucket=`` to keep same-shape traffic affine."""
    try:
        return json.dumps(payload, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return repr(payload)


class HashRing:
    """Consistent hash ring: ``vnodes`` md5 points per worker."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = max(int(vnodes), 1)
        self._points: List[Tuple[int, str]] = []
        self._hashes: List[int] = []

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")

    def _rebuild(self, names) -> None:
        pts = [(self._hash(f"{n}#{i}"), n)
               for n in names for i in range(self.vnodes)]
        pts.sort()
        self._points = pts
        self._hashes = [h for h, _ in pts]

    def add(self, name: str) -> None:
        names = {n for _, n in self._points} | {name}
        self._rebuild(names)

    def remove(self, name: str) -> None:
        names = {n for _, n in self._points} - {name}
        self._rebuild(names)

    def preference(self, key: str) -> List[str]:
        """Every worker, in ring order from the key's point: index 0 is
        the affinity owner, index 1 inherits the key if 0 dies, etc."""
        if not self._points:
            return []
        start = bisect.bisect_left(self._hashes, self._hash(key))
        seen: List[str] = []
        n = len(self._points)
        for i in range(n):
            owner = self._points[(start + i) % n][1]
            if owner not in seen:
                seen.append(owner)
        return seen

    def lookup(self, key: str) -> Optional[str]:
        pref = self.preference(key)
        return pref[0] if pref else None


@dataclass
class _Pending:
    """One unresolved client request, as the router tracks it."""
    fut: ServeFuture
    workload: str
    payload: object
    key: str
    priority: int
    hedge: bool
    slo: Optional[str]
    t_submit: float
    t_deadline: Optional[float]
    worker: str = ""
    retries: int = 0
    # survives failover: every resubmit gets a fresh wire req_id but
    # keeps this id, so spans across workers stitch into one trace
    trace_id: Optional[str] = None


@dataclass
class _WorkerSlot:
    handle: object
    state: str = "alive"             # alive | suspect | dead
    load: float = 0.0                # last heartbeat-reported backlog
    hb_seq: int = 0
    stats: Dict[str, float] = field(default_factory=dict)


class Router:
    """Consistent-hash front tier over fleet workers.  See module doc.

    ``workers`` are transport handles (``InProcWorker`` /
    ``ProcWorker`` or anything matching their duck type).  The router
    owns every client-facing ``ServeFuture``; workers only ever see
    wire messages, so a worker death cannot strand a future — the
    monitor re-submits or structurally rejects everything the dead
    worker held."""

    def __init__(self, workers: Sequence[object],
                 vnodes: Optional[int] = None,
                 max_retries: Optional[int] = None,
                 hb_timeout_s: Optional[float] = None,
                 spill_depth: Optional[float] = None,
                 chaos=None,
                 clock: Callable[[], float] = time.monotonic):
        if vnodes is None:
            vnodes = int(_env_float("REPRO_FLEET_VNODES", 64))
        if max_retries is None:
            max_retries = int(_env_float("REPRO_FLEET_MAX_RETRIES", 2))
        if hb_timeout_s is None:
            hb_timeout_s = _env_float("REPRO_FLEET_HB_TIMEOUT_S", 5.0)
        if spill_depth is None:
            spill_depth = _env_float("REPRO_FLEET_SPILL_DEPTH", 8.0)
        self.max_retries = max(int(max_retries), 0)
        self.hb_timeout_s = max(float(hb_timeout_s), 1e-3)
        self.spill_depth = max(float(spill_depth), 1.0)
        self.clock = clock
        self.chaos = chaos
        self.stats = FleetStats()
        self._rec = get_recorder()
        self._ring = HashRing(vnodes)
        self._slots: Dict[str, _WorkerSlot] = {}
        self._pending: Dict[int, _Pending] = {}
        self._assigned: Dict[str, int] = {}
        self._results: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._hb = HeartbeatMonitor([], timeout_s=self.hb_timeout_s,
                                    clock=clock)
        self._stall_resume: Dict[str, float] = {}
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._started = False
        self._draining = False
        for w in workers:
            self._register(w)
        _LIVE.add(self)

    # -- lifecycle ------------------------------------------------------
    def _register(self, handle) -> None:
        name = handle.name
        if name in self._slots:
            raise ValueError(f"duplicate worker name {name!r}")
        self._slots[name] = _WorkerSlot(handle)
        self._assigned[name] = 0
        self._ring.add(name)
        self._hb.last[name] = self.clock()

    def start(self) -> "Router":
        with self._lock:
            if self._started:
                return self
            self._started = True
        for slot in self._slots.values():
            slot.handle.start(self._on_result, self._on_heartbeat)
        # a worker process takes seconds to build its scheduler (imports,
        # a CUDA context, the span probe): its heartbeat clock starts
        # with its first beat, so wait for each (all spawned above, so
        # they start together) before the monitor begins timing them.
        # A child that exits first is dead at the monitor's first tick.
        for slot in self._slots.values():
            wait_ready = getattr(slot.handle, "wait_ready", None)
            if wait_ready is not None:
                wait_ready()
        interval = max(min(self.hb_timeout_s / 4, 0.25), 0.01)
        self._monitor = threading.Thread(
            target=self._monitor_loop, args=(interval,),
            name="serve-fleet-monitor", daemon=True)
        self._monitor.start()
        return self

    def add_worker(self, handle) -> None:
        """Elastic join: the new worker takes over its ring range for
        NEW traffic immediately; its warm state comes off the shared
        stores (zero probes), its first heartbeat confirms liveness."""
        with self._lock:
            self._register(handle)
        if self._started:
            handle.start(self._on_result, self._on_heartbeat)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admitting; True once every pending future resolved."""
        with self._lock:
            self._draining = True
        deadline = None if timeout is None else self.clock() + timeout
        with self._idle:
            while self._pending:
                wait = (None if deadline is None
                        else deadline - self.clock())
                if wait is not None and wait <= 0:
                    return False
                self._idle.wait(wait if wait is None or wait < 0.2
                                else 0.2)
        return True

    def shutdown(self, timeout: Optional[float] = 30.0) -> None:
        with self._lock:
            if self._stop.is_set():
                return
            self._draining = True
        self.drain(timeout)
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout)
            self._monitor = None
        for slot in self._slots.values():
            try:
                slot.handle.shutdown(timeout=timeout
                                     if timeout is not None else 10.0)
            except Exception:                      # noqa: BLE001
                pass
        # anything still unresolved after worker shutdown gets the
        # structured goodbye, exactly once
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
            for name in self._assigned:
                self._assigned[name] = 0
        for p in leftovers:
            if p.fut._reject(RequestRejected(Rejection(
                    "shutdown", p.workload,
                    detail="router shut down"))):
                self.stats.inc(rejected_shutdown=1)
                with self._idle:
                    self._idle.notify_all()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- introspection --------------------------------------------------
    def worker_states(self) -> Dict[str, str]:
        with self._lock:
            return {n: s.state for n, s in self._slots.items()}

    def worker_stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {n: dict(s.stats) for n, s in self._slots.items()}

    def owner(self, key: str) -> Optional[str]:
        """The worker that owns ``key`` on the hash ring (its first
        preference, alive or not)."""
        with self._lock:
            return self._ring.lookup(key)

    def pending_on(self, name: str) -> int:
        """Unresolved requests placed on worker ``name`` now."""
        with self._lock:
            return sum(p.worker == name for p in self._pending.values())

    def results_by_worker(self) -> Dict[str, int]:
        """Result messages received from each worker, late duplicates
        included."""
        with self._lock:
            return dict(self._results)

    def degraded(self) -> bool:
        with self._lock:
            return self._degraded_locked()

    def _degraded_locked(self) -> bool:
        return any(s.state != "alive" for s in self._slots.values())

    def refresh_stats(self, timeout: float = 5.0) -> Dict[str, dict]:
        """Ping every alive worker and wait for a fresh heartbeat from
        each, so callers read post-traffic counters, not a stale beat."""
        with self._lock:
            want = {n: s.hb_seq for n, s in self._slots.items()
                    if s.state == "alive"
                    and hasattr(s.handle, "ping")}
        for n in want:
            self._slots[n].handle.ping()
        deadline = self.clock() + timeout
        while self.clock() < deadline:
            with self._lock:
                if all(self._slots[n].hb_seq > seq
                       for n, seq in want.items()):
                    break
            time.sleep(0.01)
        return self.worker_stats()

    # -- submission -----------------------------------------------------
    def submit(self, workload: str, payload=None,
               deadline: Optional[float] = None, priority: int = 0,
               hedge: bool = False,
               bucket: Optional[str] = None,
               slo_class: Optional[str] = None) -> ServeFuture:
        """Route one request to its affinity worker.  Same client
        contract as ``Scheduler.submit``: never blocks, every future
        resolves exactly once — with a value, an application error, or
        a structured ``RequestRejected``.  ``slo_class`` rides the wire
        to the worker's scheduler (class-aware admission); None keeps
        the derived default."""
        self.start()
        fut = ServeFuture()
        now = self.clock()
        key = f"{workload}|{bucket if bucket is not None else default_bucket(payload)}"
        rec = self._rec
        trace_id = new_trace_id() if rec.enabled else None
        p = _Pending(fut, workload, payload, key, priority, hedge,
                     slo_class, t_submit=now,
                     t_deadline=None if deadline is None
                     else now + max(deadline, 0.0),
                     trace_id=trace_id)
        self.stats.inc(submitted=1)
        with self._lock:
            if self._draining:
                reject = Rejection("shutdown", workload,
                                   detail="router is draining")
            elif priority < 0 and self._degraded_locked():
                reject = Rejection(
                    "brownout", workload,
                    detail="best-effort shed: fleet degraded "
                           "(a worker is down or suspect)")
            else:
                reject = None
        if reject is not None:
            self.stats.inc(rejected_shutdown=1 if reject.reason
                           == "shutdown" else 0,
                           shed_brownout=1 if reject.reason
                           == "brownout" else 0)
            rec.instant("brownout" if reject.reason == "brownout"
                        else "shed", "fault", "router", trace_id,
                        workload=workload, reason=reject.reason)
            fut._reject(RequestRejected(reject))
            return fut
        rec.instant("submit", "request", "router", trace_id,
                    workload=workload)
        self._place(p, deadline_remaining=deadline)
        return fut

    def _pick_worker_locked(self, key: str) -> Tuple[Optional[str], bool]:
        """(worker, spilled): ring preference order filtered to alive
        workers, with spill-on-hot — an overloaded affinity owner is
        bypassed when a clearly lighter alive worker exists."""
        pref = [n for n in self._ring.preference(key)
                if self._slots[n].state == "alive"]
        if not pref:
            return None, False
        primary = pref[0]

        def load(n: str) -> float:
            return max(self._slots[n].load, float(self._assigned[n]))

        if len(pref) > 1 and load(primary) >= self.spill_depth:
            alt = min(pref[1:], key=load)
            if load(alt) <= load(primary) / 2.0:
                return alt, True
        return primary, False

    def _place(self, p: _Pending,
               deadline_remaining: Optional[float] = None) -> None:
        """Assign ``p`` to a worker and ship it.  Called at submit and
        again on every failover resubmit."""
        now = self.clock()
        if p.fut.done():
            return
        if p.t_deadline is not None:
            deadline_remaining = p.t_deadline - now
            if deadline_remaining <= 0:
                if p.fut._reject(RequestRejected(Rejection(
                        "deadline", p.workload,
                        detail="deadline passed during fleet failover",
                        waited_s=now - p.t_submit))):
                    self.stats.inc(rejected_upstream=1)
                    with self._idle:
                        self._idle.notify_all()
                return
        with self._lock:
            name, spilled = self._pick_worker_locked(p.key)
            if name is not None:
                if spilled:
                    self.stats.inc(spills=1)
                rid = next(self._ids)
                p.worker = name
                self._pending[rid] = p
                self._assigned[name] += 1
        if name is None:
            if p.fut._reject(RequestRejected(Rejection(
                    "worker_failure", p.workload,
                    detail="no alive fleet worker"))):
                self.stats.inc(rejected_failure=1)
                with self._idle:
                    self._idle.notify_all()
            return
        self._rec.instant("place", "request", "router", p.trace_id,
                          workload=p.workload, worker=name, rid=rid,
                          spilled=spilled, retry=p.retries)
        ok = self._slots[name].handle.submit(SubmitMsg(
            req_id=rid, workload=p.workload, payload=p.payload,
            deadline_s=deadline_remaining, priority=p.priority,
            hedge=p.hedge, trace_id=p.trace_id, slo=p.slo))
        if not ok:
            # the transport is already broken: declare the worker dead
            # now (the monitor would within a tick) — that re-hashes
            # its range and resubmits everything it held, p included
            self._worker_dead(name, "transport refused submit")

    # -- worker callbacks (result + heartbeat delivery threads) ---------
    def _on_result(self, name: str, msg) -> None:
        with self._lock:
            self._results[name] = self._results.get(name, 0) + 1
            p = self._pending.pop(msg.req_id, None)
            if p is not None and p.worker in self._assigned:
                self._assigned[p.worker] = max(
                    self._assigned[p.worker] - 1, 0)
        if p is None:
            # late completion for a request that failed over (or a
            # duplicate): exactly-once means it is a counted no-op
            self.stats.inc(duplicate_results=1)
            with self._idle:
                self._idle.notify_all()
            return
        now = self.clock()
        if msg.ok:
            first = p.fut._resolve(msg.value)
        elif msg.rejection is not None:
            first = p.fut._reject(RequestRejected(msg.rejection))
        else:
            first = p.fut._reject(RuntimeError(
                msg.error or "worker execution failed"))
        if first:
            self._rec.instant("result", "request", "router", p.trace_id,
                              workload=p.workload, worker=name,
                              ok=msg.ok, latency_s=now - p.t_submit)
        if not first:
            self.stats.inc(duplicate_results=1)
        elif msg.ok:
            with self.stats.lock:
                self.stats.completed += 1
                self.stats.latency_s.observe(now - p.t_submit)
                self.stats.latency_q.observe(now - p.t_submit)
        elif msg.rejection is not None:
            self.stats.inc(rejected_upstream=1)
        else:
            self.stats.inc(failed=1)
        with self._idle:
            self._idle.notify_all()

    def _on_heartbeat(self, name: str, msg) -> None:
        self._hb.beat(name)
        rejoined = False
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                return
            slot.load = float(msg.load)
            slot.stats = dict(msg.stats)
            slot.hb_seq += 1
            if slot.state != "alive":
                # beats resumed: suspect/dead -> alive (rejoined).  Its
                # resubmitted requests already live elsewhere; whatever
                # it still answers are no-op duplicates.
                slot.state = "alive"
                rejoined = True
        spans = getattr(msg, "spans", ())
        if spans:
            # stitch the worker's events onto the fleet timeline; the
            # prefix becomes the process name in the Chrome export
            self._rec.ingest(list(spans), track_prefix=f"{name}/")
        if rejoined:
            self.stats.inc(worker_rejoins=1)
            with self._idle:
                self._idle.notify_all()

    # -- failure detection + failover -----------------------------------
    def _monitor_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self._monitor_tick()
            except Exception:                      # noqa: BLE001
                pass                   # robustness layer must not die

    def _monitor_tick(self) -> None:
        now = self.clock()
        self._apply_chaos(now)
        for name in list(self._slots):
            slot = self._slots[name]
            handle = slot.handle
            with self._lock:
                state = slot.state
            if state == "dead":
                continue
            if not getattr(handle, "transport_alive", True):
                # the process exited / the pipe broke: no grace period
                self._worker_dead(name, "transport down")
                continue
            age = now - self._hb.last.get(name, now)
            if state == "alive" and age > self.hb_timeout_s:
                with self._idle:
                    if slot.state == "alive":
                        slot.state = "suspect"
                        self.stats.inc(worker_suspects=1)
                        self._idle.notify_all()
            elif state == "suspect" and age > 2 * self.hb_timeout_s:
                self._worker_dead(name, "missed heartbeats")

    def _apply_chaos(self, now: float) -> None:
        inj = self.chaos
        if inj is None or not hasattr(inj, "at_time_proc"):
            return
        for f in inj.at_time_proc():
            handle = self._slots.get(f.worker, _WorkerSlot(None)).handle
            if handle is None:
                continue
            try:
                if f.kind == "kill9" and hasattr(handle, "kill"):
                    handle.kill()
                elif f.kind == "stall" and hasattr(handle, "stall"):
                    handle.stall()
                    if f.duration_s > 0:
                        self._stall_resume[f.worker] = now + f.duration_s
                elif f.kind == "slow" and hasattr(handle, "slow"):
                    handle.slow(f.factor, f.duration_s)
                elif f.kind == "restart" and hasattr(handle, "restart"):
                    self._restart(f.worker, handle)
            except Exception:                      # noqa: BLE001
                pass
        for name, t in list(self._stall_resume.items()):
            if now >= t:
                del self._stall_resume[name]
                handle = self._slots[name].handle
                if hasattr(handle, "resume"):
                    handle.resume()

    def _worker_dead(self, name: str, why: str) -> None:
        """Failover: mark dead, re-hash the key range (implicit — the
        ring skips dead workers), re-submit every unresolved request it
        held.  Idempotent per death."""
        with self._idle:
            slot = self._slots.get(name)
            if slot is None or slot.state == "dead":
                return
            slot.state = "dead"
            slot.load = 0.0
            self.stats.inc(worker_deaths=1)
            moved = [(rid, p) for rid, p in self._pending.items()
                     if p.worker == name]
            for rid, _ in moved:
                del self._pending[rid]
            self._assigned[name] = 0
            self._idle.notify_all()
        self._rec.instant("worker_dead", "fault", "router",
                          worker=name, why=why, moved=len(moved))
        for _, p in moved:
            self._resubmit(p, why)

    def _resubmit(self, p: _Pending, why: str) -> None:
        """Re-place one failed-over request under the retry budget.
        Exactly-once: a request whose original execution already
        resolved is dropped here (duplicate resolves are no-ops
        anyway); budget exhaustion is a structured rejection."""
        if p.fut.done():
            return
        with self._idle:
            if p.retries >= self.max_retries:
                if p.fut._reject(RequestRejected(Rejection(
                        "worker_failure", p.workload,
                        detail=f"resubmit budget ({self.max_retries}) "
                               f"exhausted: {why}"))):
                    self.stats.inc(rejected_failure=1)
                    self._idle.notify_all()
                return
            p.retries += 1
            self.stats.inc(resubmits=1)
        self._rec.instant("failover_resubmit", "fault", "router",
                          p.trace_id, workload=p.workload,
                          from_worker=p.worker, retry=p.retries,
                          why=why)
        self._place(p)

    def restart_worker(self, name: str) -> None:
        """Chaos/ops revive: restart the worker's transport.  State
        flips back to alive on its first heartbeat (rejoin)."""
        handle = self._slots[name].handle
        if hasattr(handle, "restart"):
            self._restart(name, handle)

    def _restart(self, name: str, handle) -> None:
        """A restart ends the worker's old process, so nothing it held
        can be answered any more: it fails over first (a no-op when its
        death was already detected), then the transport restarts."""
        self._worker_dead(name, "restarted")
        handle.restart()
