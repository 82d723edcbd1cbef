"""Failure detection & injection.

Real deployments detect dead slices via missed heartbeats; tests and the
examples inject failures deterministically (``FailureInjector``).  The
trainer (``train.trainer``) reacts the same way to both: mark the group
dead, re-plan work shares (elastic), restore from the last checkpoint if
the failed group held non-replicated state.

The serving scheduler consumes these primitives at lane granularity:
idle lane workers beat through ``HeartbeatMonitor``, the watchdog thread
converts exceeded execution deadlines into failovers, and
``ChaosInjector`` scripts *time-based* lane faults (kill, hang-for-T,
slowdown-by-X, flaky-with-probability-p) over a request trace.
``ProcFault`` scripts faults against whole fleet worker processes, for
the fleet router.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


class LaneFailure(RuntimeError):
    """An execution failed because its lane did, not because the request
    was bad.  The scheduler retries these (adapters are pure, so a
    duplicate execution is safe); any other exception still fails the
    request's future — application errors must not burn retry budget."""


class HeartbeatMonitor:
    """Tracks per-group heartbeats; a group is dead after ``timeout_s``."""

    def __init__(self, groups, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[str, float] = {g: clock() for g in groups}
        self.dead: Set[str] = set()

    def beat(self, group: str) -> None:
        self.last[group] = self.clock()
        self.dead.discard(group)

    def check(self) -> Set[str]:
        now = self.clock()
        for g, t in self.last.items():
            if now - t > self.timeout:
                self.dead.add(g)
        return set(self.dead)


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples.

    kill[step] = group to kill at that step; revive[step] = group to
    bring back (elastic join)."""
    kill: Dict[int, str] = field(default_factory=dict)
    revive: Dict[int, str] = field(default_factory=dict)

    def at_step(self, step: int):
        return self.kill.get(step), self.revive.get(step)


@dataclass(frozen=True)
class ProcFault:
    """One scripted *process-level* fault against a fleet worker, at
    ``t`` seconds after ``arm()``.  Where ``LaneFault`` degrades a
    device lane inside one scheduler, a ``ProcFault`` takes out the
    whole worker process behind the fleet router.

    kind:
      ``kill9``   — SIGKILL the worker (in-process fakes cut their
                    transport); no goodbye, the router must *detect* it.
      ``stall``   — SIGSTOP for ``duration_s`` (SIGCONT after): the
                    process is alive but wedged — heartbeats stop, the
                    router's suspect/dead machinery takes over.
      ``slow``    — worker delivers results ``factor`` x late for
                    ``duration_s`` (backlog builds; spill territory).
      ``restart`` — relaunch the worker's transport (revive after a
                    ``kill9``); it rejoins on its first heartbeat.
    """
    t: float
    worker: str
    kind: str
    duration_s: float = 0.0
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in ("kill9", "stall", "slow", "restart"):
            raise ValueError(f"unknown proc fault kind {self.kind!r}")


@dataclass(frozen=True)
class LaneFault:
    """One scripted lane fault, at ``t`` seconds after ``arm()``.

    kind:
      ``kill``   — lane dies at ``t`` (until a later ``revive``);
                   executions attempted on it raise ``LaneFailure``.
      ``revive`` — lane comes back at ``t`` (elastic rejoin).
      ``hang``   — executions starting in ``[t, t+duration_s]`` stall
                   ``duration_s`` before running (watchdog territory).
      ``slow``   — executions in the window take ``factor`` x as long
                   (feeds slowed times into calibration, so survivors'
                   projections recalibrate).
      ``flaky``  — executions in the window raise ``LaneFailure`` with
                   probability ``p`` (retry-budget territory).
    """
    t: float
    lane: str
    kind: str
    duration_s: float = 0.0
    factor: float = 1.0
    p: float = 0.0

    def __post_init__(self):
        if self.kind not in ("kill", "revive", "hang", "slow", "flaky"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class ChaosInjector:
    """Time-based scripted lane faults for the serving scheduler.

    Where ``FailureInjector`` is indexed by dispatch step (fine for
    lockstep training), a serving trace is asynchronous — faults land at
    wall-clock offsets from ``arm()`` (called when trace replay starts;
    lazily armed on first use otherwise).  The scheduler polls
    ``at_time`` for lane-state transitions (kill/revive, each delivered
    exactly once) and asks ``exec_fault`` at execution start for the
    active execution-level fault on a lane, if any.  The fleet router
    polls ``at_time_proc`` the same way for scripted ``ProcFault``s
    against whole worker processes (the fault list may mix both kinds).

    Deterministic given the same timeline: flaky draws use a seeded RNG.
    """

    def __init__(self, faults: Sequence[object],
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0):
        self.faults: List[LaneFault] = sorted(
            (f for f in faults if isinstance(f, LaneFault)),
            key=lambda f: f.t)
        self.proc_faults: List[ProcFault] = sorted(
            (f for f in faults if isinstance(f, ProcFault)),
            key=lambda f: f.t)
        self.clock = clock
        self._rng = random.Random(seed)
        self._t0: Optional[float] = None
        self._emitted: Set[int] = set()
        self._emitted_proc: Set[int] = set()
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, faults: Sequence[dict],
                  clock: Callable[[], float] = time.monotonic,
                  seed: int = 0) -> "ChaosInjector":
        """Build from a JSON-friendly fault list (the scenario engine's
        on-disk form).  Each dict needs ``t`` + ``kind`` and either
        ``lane`` (LaneFault) or ``worker`` (ProcFault); the remaining
        keys (``duration_s``, ``factor``, ``p``) pass through.  Unknown
        kinds fail loudly via the dataclass validators — a scenario
        with a typo'd fault must not silently run fault-free."""
        built: List[object] = []
        for f in faults:
            f = dict(f)
            if "worker" in f:
                built.append(ProcFault(**f))
            elif "lane" in f:
                built.append(LaneFault(**f))
            else:
                raise ValueError(
                    f"fault spec needs 'lane' or 'worker': {f!r}")
        return cls(built, clock=clock, seed=seed)

    def arm(self, t0: Optional[float] = None) -> None:
        """Start the fault clock (idempotent)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self.clock() if t0 is None else t0

    def _elapsed(self) -> float:
        with self._lock:
            if self._t0 is None:
                self._t0 = self.clock()
            return self.clock() - self._t0

    def at_time(self, now: Optional[float] = None
                ) -> Tuple[List[str], List[str]]:
        """(lanes newly killed, lanes newly revived) since the last
        call.  Each scripted kill/revive is emitted exactly once."""
        del now  # the armed clock is authoritative
        e = self._elapsed()
        kills: List[str] = []
        revives: List[str] = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.t > e or i in self._emitted:
                    continue
                if f.kind == "kill":
                    self._emitted.add(i)
                    kills.append(f.lane)
                elif f.kind == "revive":
                    self._emitted.add(i)
                    revives.append(f.lane)
        return kills, revives

    def at_time_proc(self, now: Optional[float] = None
                     ) -> List[ProcFault]:
        """Process-level faults newly due since the last call, in
        script order.  Each is emitted exactly once; the router applies
        them to worker transports (SIGKILL/SIGSTOP/slow/restart)."""
        del now
        e = self._elapsed()
        due: List[ProcFault] = []
        with self._lock:
            for i, f in enumerate(self.proc_faults):
                if f.t <= e and i not in self._emitted_proc:
                    self._emitted_proc.add(i)
                    due.append(f)
        return due

    def exec_fault(self, lane: str,
                   now: Optional[float] = None) -> Optional[LaneFault]:
        """The execution-level fault active on ``lane`` right now, or
        None.  A kill is active from its ``t`` until the lane's next
        scripted revive; hang/slow windows are ``[t, t+duration_s]``;
        flaky windows draw ``p`` per call."""
        del now
        e = self._elapsed()
        killed = False
        for f in self.faults:
            if f.lane != lane or f.t > e:
                continue
            if f.kind == "kill":
                killed = True
            elif f.kind == "revive":
                killed = False
        if killed:
            return LaneFault(t=e, lane=lane, kind="kill")
        for f in self.faults:
            if (f.lane == lane and f.kind in ("hang", "slow", "flaky")
                    and f.t <= e <= f.t + f.duration_s):
                if f.kind == "flaky":
                    with self._lock:
                        hit = self._rng.random() < f.p
                    return f if hit else None
                return f
        return None
