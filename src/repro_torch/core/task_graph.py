"""Task parallelism — the paper's second solution methodology (§1, §5.4.4).

Computation expressed as a DAG of tasks with per-device-class costs and
communication edges; a HEFT-style list scheduler maps tasks to devices
minimizing earliest finish time, matching the paper's "right task on the
right processor" discipline.  The paper notes optimal mapping is
NP-complete and uses near-optimal heuristics — HEFT is that heuristic.

Reproduces the paper's Fig. 5 (LR task assignment) and drives the
host-offload scheduling in the trainer (host tasks = the 'CPU', device
steps = the 'GPU').

Pure Python: a copy of the reference's module (the port imports
nothing of the reference), scheduling any DAG exactly as it does.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class Task:
    name: str
    # cost (seconds) per device class, e.g. {"cpu": 0.3, "gpu": 0.02};
    # a missing class means the task cannot run there.
    costs: Dict[str, float]
    deps: List[str] = field(default_factory=list)
    output_bytes: float = 0.0
    fn: Optional[Callable] = None    # optional executable payload


@dataclass
class Assignment:
    task: str
    device: str
    device_class: str
    start: float
    end: float


@dataclass
class Schedule:
    assignments: Dict[str, Assignment]
    makespan: float
    idle_frac: Dict[str, float]      # per device
    critical_path: List[str]

    def resource_efficiency(self) -> float:
        if not self.idle_frac:
            return 1.0
        return 1.0 - sum(self.idle_frac.values()) / len(self.idle_frac)


class TaskGraph:
    def __init__(self):
        self.tasks: Dict[str, Task] = {}
        self.last_measured_makespan = 0.0

    def add(self, name: str, costs: Dict[str, float],
            deps: Sequence[str] = (), output_bytes: float = 0.0,
            fn: Optional[Callable] = None) -> "TaskGraph":
        if name in self.tasks:
            raise ValueError(f"duplicate task {name}")
        for d in deps:
            if d not in self.tasks:
                raise ValueError(f"unknown dep {d} for {name}")
        self.tasks[name] = Task(name, dict(costs), list(deps),
                                output_bytes, fn)
        return self

    # ------------------------------------------------------------------
    def _toposort(self) -> List[str]:
        indeg = {n: len(t.deps) for n, t in self.tasks.items()}
        kids: Dict[str, List[str]] = {n: [] for n in self.tasks}
        for n, t in self.tasks.items():
            for d in t.deps:
                kids[d].append(n)
        order = [n for n, d in indeg.items() if d == 0]
        out = []
        while order:
            n = order.pop()
            out.append(n)
            for k in kids[n]:
                indeg[k] -= 1
                if indeg[k] == 0:
                    order.append(k)
        if len(out) != len(self.tasks):
            raise ValueError("task graph has a cycle")
        return out

    def _upward_rank(self, link_bw: float) -> Dict[str, float]:
        """HEFT upward rank: mean cost + max over children of
        (edge comm + child rank)."""
        kids: Dict[str, List[str]] = {n: [] for n in self.tasks}
        for n, t in self.tasks.items():
            for d in t.deps:
                kids[d].append(n)
        rank: Dict[str, float] = {}
        for n in reversed(self._toposort()):
            t = self.tasks[n]
            mean_cost = sum(t.costs.values()) / len(t.costs)
            child = 0.0
            for k in kids[n]:
                comm = t.output_bytes / link_bw if link_bw else 0.0
                child = max(child, comm + rank[k])
            rank[n] = mean_cost + child
        return rank

    # ------------------------------------------------------------------
    def schedule(self, devices: Dict[str, str],
                 link_bw: float = 6e9) -> Schedule:
        """HEFT list scheduling.

        devices: device name -> device class (e.g. {"cpu0": "cpu",
        "gpu0": "gpu"}).  link_bw defaults to the paper's 6 GB/s PCIe.
        """
        rank = self._upward_rank(link_bw)
        order = sorted(self.tasks, key=lambda n: -rank[n])
        dev_free = {d: 0.0 for d in devices}
        dev_busy = {d: 0.0 for d in devices}
        assign: Dict[str, Assignment] = {}
        for name in order:
            t = self.tasks[name]
            best: Optional[Assignment] = None
            for dev, cls in devices.items():
                if cls not in t.costs:
                    continue
                ready = 0.0
                for dep in t.deps:
                    a = assign[dep]
                    comm = 0.0
                    if a.device != dev:
                        comm = self.tasks[dep].output_bytes / link_bw \
                            if link_bw else 0.0
                    ready = max(ready, a.end + comm)
                start = max(ready, dev_free[dev])
                end = start + t.costs[cls]
                if best is None or end < best.end:
                    best = Assignment(name, dev, cls, start, end)
            if best is None:
                raise ValueError(f"no device can run task {name}")
            assign[name] = best
            dev_free[best.device] = best.end
            dev_busy[best.device] += best.end - best.start
        makespan = max((a.end for a in assign.values()), default=0.0)
        idle = {d: (makespan - dev_busy[d]) / makespan if makespan else 0.0
                for d in devices}
        # critical path: walk back from the last-finishing task
        cp: List[str] = []
        cur = max(assign.values(), key=lambda a: a.end).task if assign else None
        while cur is not None:
            cp.append(cur)
            deps = self.tasks[cur].deps
            cur = max(deps, key=lambda d: assign[d].end) if deps else None
        return Schedule(assign, makespan, idle, list(reversed(cp)))

    # ------------------------------------------------------------------
    def execute(self, schedule: Optional[Schedule] = None,
                concurrent: bool = False) -> Dict[str, object]:
        """Run task payloads.

        Serial mode (default): dependency order in one thread; the
        schedule is only bookkeeping.

        Concurrent mode: one worker thread per scheduled device, each
        running its lane's tasks in HEFT start-time order and blocking
        on cross-lane dependencies — payloads assigned to different
        devices genuinely overlap, matching the schedule the paper's
        Fig. 5 timeline draws.  The measured wall-clock span is stored
        in ``self.last_measured_makespan``."""
        if not concurrent or schedule is None:
            results: Dict[str, object] = {}
            t0 = time.perf_counter()
            for name in self._toposort():
                t = self.tasks[name]
                if t.fn is not None:
                    results[name] = t.fn(*[results.get(d) for d in t.deps])
            self.last_measured_makespan = time.perf_counter() - t0
            return results

        lanes: Dict[str, List[Assignment]] = {}
        for a in schedule.assignments.values():
            lanes.setdefault(a.device, []).append(a)
        for lane in lanes.values():
            lane.sort(key=lambda a: (a.start, a.end))
        results = {}
        res_lock = threading.Lock()
        done = {name: threading.Event() for name in self.tasks}
        errors: List[BaseException] = []

        abort = threading.Event()

        def lane_worker(assignments: List[Assignment]) -> None:
            try:
                for a in assignments:
                    t = self.tasks[a.task]
                    for d in t.deps:
                        while not done[d].wait(0.05):
                            if abort.is_set():
                                return
                    # a failed lane force-sets its done events without
                    # results — dependents must not run on garbage args
                    if abort.is_set():
                        return
                    with res_lock:
                        args = [results.get(d) for d in t.deps]
                    if t.fn is not None:
                        out = t.fn(*args)
                        with res_lock:
                            results[a.task] = out
                    done[a.task].set()
            except BaseException as e:       # noqa: BLE001 — re-raised below
                errors.append(e)
                abort.set()
            finally:
                # unblock any lane waiting on this lane's tasks (they
                # check `abort` before executing)
                for a in assignments:
                    done[a.task].set()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=lane_worker, args=(lane,),
                                    name=f"lane-{dev}")
                   for dev, lane in lanes.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self.last_measured_makespan = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return results
