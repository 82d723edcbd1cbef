"""Scenario engine: recorded, replayable, seeded traffic traces.

The paper's claim is not "hybrid wins on one Poisson mix" — it is that
CPU+GPU placement stays ~90% resource-efficient across 13 *diverse*
workloads, and placement quality only becomes visible under varied
traffic regimes (Gharaibeh et al. make the same point for graph
partitions).  `serving_bench.py` judged every scheduler change against
a single synthetic open-loop mix; this module replaces that single
point with a *portfolio*: named scenarios (diurnal ramp, flash crowd,
heavy-tail shapes, workload-mix drift, chaos-mid-trace) described as
JSON specs under ``repro_torch/benchmarks/scenarios/`` (copies of the
reference's, held equal to them by a test), replayed deterministically
from a seed.

Determinism contract: ``build_trace(spec)`` is a pure function of the
spec (seed included) — the same spec replays a byte-identical event
sequence (workload, payload bucket, SLO class, deadline, t_arrival)
across fresh processes.  ``trace_digest`` hashes the canonical event
tuples so two processes can *prove* they replayed the same trace.

Two drive modes:

* **open-loop** (default): events fire at their scripted ``t_arrival``
  regardless of completions — arrival pressure is part of the recorded
  scenario (a flash crowd does not slow down because the server did).
* **closed-loop**: ``n_clients`` client loops each draw requests from
  the same seeded stream but issue-on-completion with a think time —
  arrivals *depend on* completions, which is exactly the regime where
  accounting bugs (a dropped future stalls a client forever) surface.

Every request carries an SLO class (``request_queue.SLO_CLASSES``);
``run_scenario`` reports per-class p50/p95 latency and goodput
(deadline-met completions/sec for deadline classes, completions/sec
otherwise) plus the scheduler's accounting counters, and asserts the
accounting invariant: nothing submitted may vanish without a structured
verdict.

Env knobs: ``REPRO_SCENARIO_SEED`` overrides every spec's seed (sweep
replays), ``REPRO_SCENARIO_SCALE`` multiplies event counts (stress).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.serve.request_queue import (SLO_CLASSES, RequestRejected,
                                       resolve_slo_class)

__all__ = ["Phase", "ScenarioSpec", "TraceEvent", "build_trace",
           "trace_digest", "load_spec", "run_scenario",
           "accounting_invariant"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Phase:
    """One regime within a scenario: ``duration_s`` of arrivals at
    ``rate_scale`` x the spec's base rate, drawn from ``mix`` (workload
    -> weight; falls back to the spec-level mix).  Rate ramps linearly
    into ``ramp_to`` when set — that is the diurnal shape."""
    duration_s: float
    rate_scale: float = 1.0
    ramp_to: Optional[float] = None
    mix: Optional[Dict[str, float]] = None


@dataclass(frozen=True)
class ScenarioSpec:
    """A replayable traffic scenario (JSON round-trip via
    ``to_dict``/``from_dict``; files live in
    ``repro_torch/benchmarks/scenarios/``).

    ``workloads`` maps a workload key to its event template::

        {"payload": {...} | [bucketed payloads...],
         "slo": "latency" | "batch" | "best_effort" (optional),
         "deadline_s": float (optional),
         "weight": float (spec-level mix weight, default 1)}

    ``payload`` as a list is a *bucket distribution*: each event draws
    one entry; ``bucket_tail`` > 0 biases draws toward the head with a
    Zipf-like tail (heavy-tail shape scenarios).  ``base_rate`` is
    requests/sec at ``rate_scale=1``; arrivals within a phase are a
    seeded Poisson process (exponential gaps).  ``faults`` is a JSON
    fault list for ``ChaosInjector.from_spec``.  ``closed_loop``
    switches drive mode (``n_clients``, ``think_s``)."""
    name: str
    workloads: Dict[str, dict]
    phases: Sequence[Phase]
    base_rate: float = 50.0
    seed: int = 0
    bucket_tail: float = 0.0
    faults: Sequence[dict] = ()
    closed_loop: bool = False
    n_clients: int = 8
    think_s: float = 0.01
    # replay knobs (not part of the trace identity): scheduler kwargs
    # the runner forwards, e.g. {"max_queue": 64}
    sched: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "workloads": {k: dict(v) for k, v in self.workloads.items()},
            "phases": [{k: v for k, v in {
                "duration_s": p.duration_s,
                "rate_scale": p.rate_scale,
                "ramp_to": p.ramp_to,
                "mix": p.mix}.items() if v is not None}
                for p in self.phases],
            "base_rate": self.base_rate,
            "seed": self.seed,
            "bucket_tail": self.bucket_tail,
            "faults": [dict(f) for f in self.faults],
            "closed_loop": self.closed_loop,
            "n_clients": self.n_clients,
            "think_s": self.think_s,
            "sched": dict(self.sched),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        d["phases"] = tuple(Phase(**p) for p in d.get("phases", ()))
        d["faults"] = tuple(d.get("faults", ()))
        return cls(**d)


def load_spec(path: str) -> ScenarioSpec:
    with open(path) as fh:
        return ScenarioSpec.from_dict(json.load(fh))


# ---------------------------------------------------------------------------
# Deterministic trace generation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TraceEvent:
    """One scripted arrival.  ``payload_index`` selects the drawn
    bucket within the workload's payload list (-1: scalar payload) —
    the canonical tuple keeps the *index*, not the payload object, so
    the digest is stable across payload dict ordering."""
    t_arrival: float
    workload: str
    payload_index: int
    slo: str
    deadline_s: Optional[float]

    def canonical(self) -> tuple:
        return (round(self.t_arrival, 9), self.workload,
                self.payload_index, self.slo,
                None if self.deadline_s is None
                else round(self.deadline_s, 9))


class _Lcg:
    """Tiny deterministic generator (64-bit LCG): the trace identity
    must not depend on Python/numpy RNG implementation details that
    could drift across versions."""

    MULT = 6364136223846793005
    INC = 1442695040888963407
    MASK = (1 << 64) - 1

    def __init__(self, seed: int):
        self.state = (seed * 2862933555777941757 + 3037000493) & self.MASK
        for _ in range(4):                    # scramble small seeds
            self.next_u64()

    def next_u64(self) -> int:
        self.state = (self.state * self.MULT + self.INC) & self.MASK
        return self.state

    def uniform(self) -> float:
        return (self.next_u64() >> 11) / float(1 << 53)

    def expovariate(self, rate: float) -> float:
        u = self.uniform()
        return -math.log(1.0 - u) / max(rate, 1e-12)


def _pick_weighted(rng: _Lcg, items: List[tuple]) -> str:
    total = sum(w for _, w in items)
    x = rng.uniform() * total
    for key, w in items:
        x -= w
        if x <= 0:
            return key
    return items[-1][0]


def _pick_bucket(rng: _Lcg, n: int, tail: float) -> int:
    """Bucket draw; ``tail`` > 0 gives a Zipf-ish head bias (index 0
    most common), 0 is uniform."""
    if n <= 1:
        return 0
    if tail <= 0:
        return min(int(rng.uniform() * n), n - 1)
    weights = [1.0 / (i + 1) ** tail for i in range(n)]
    total = sum(weights)
    x = rng.uniform() * total
    for i, w in enumerate(weights):
        x -= w
        if x <= 0:
            return i
    return n - 1


def build_trace(spec: ScenarioSpec,
                scale: Optional[float] = None) -> List[TraceEvent]:
    """The scenario's full arrival script, deterministically from the
    spec.  ``REPRO_SCENARIO_SEED`` (when set) overrides the spec seed;
    ``scale``/``REPRO_SCENARIO_SCALE`` multiplies the base rate (event
    *times* compress, the regime shapes are preserved)."""
    seed = _env_int("REPRO_SCENARIO_SEED", spec.seed)
    if scale is None:
        scale = _env_float("REPRO_SCENARIO_SCALE", 1.0)
    rng = _Lcg(seed ^ hash_name(spec.name))
    spec_mix = [(k, float(v.get("weight", 1.0)))
                for k, v in sorted(spec.workloads.items())]
    events: List[TraceEvent] = []
    t = 0.0
    for phase in spec.phases:
        mix = (sorted(phase.mix.items()) if phase.mix is not None
               else spec_mix)
        mix = [(k, float(w)) for k, w in mix]
        t_phase = 0.0
        r0 = phase.rate_scale
        r1 = phase.ramp_to if phase.ramp_to is not None else r0
        while t_phase < phase.duration_s:
            frac = t_phase / max(phase.duration_s, 1e-12)
            rate = spec.base_rate * scale * (r0 + (r1 - r0) * frac)
            gap = rng.expovariate(max(rate, 1e-9))
            t_phase += gap
            if t_phase >= phase.duration_s:
                break
            wl = _pick_weighted(rng, mix)
            cfg = spec.workloads[wl]
            payload = cfg.get("payload")
            if isinstance(payload, list):
                idx = _pick_bucket(rng, len(payload), spec.bucket_tail)
            else:
                idx = -1
            deadline = cfg.get("deadline_s")
            slo = resolve_slo_class(cfg.get("slo"), 0, deadline, False)
            events.append(TraceEvent(t + t_phase, wl, idx, slo,
                                     None if deadline is None
                                     else float(deadline)))
        t += phase.duration_s
    return events


def hash_name(name: str) -> int:
    """Stable (cross-process) 32-bit hash — ``hash()`` is salted."""
    return int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:4], "big")


def trace_digest(events: Sequence[TraceEvent]) -> str:
    """sha256 over the canonical event tuples: two processes that
    print the same digest provably replayed the same trace."""
    h = hashlib.sha256()
    for ev in events:
        h.update(repr(ev.canonical()).encode())
    return h.hexdigest()


def event_payload(spec: ScenarioSpec, ev: TraceEvent):
    cfg = spec.workloads[ev.workload]
    payload = cfg.get("payload")
    if ev.payload_index >= 0:
        return payload[ev.payload_index]
    return payload


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------
class _ClassStats:
    """Latency/goodput accumulator for one SLO class."""

    def __init__(self):
        self.latencies: List[float] = []
        self.completed = 0
        self.deadline_met = 0
        self.rejected = 0
        self.failed = 0

    def quantile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        i = min(int(q * len(xs)), len(xs) - 1)
        return xs[i]


def accounting_invariant(stats: Dict[str, float]) -> int:
    """The accounting invariant: submitted == every structured verdict +
    still in flight.  Returns ``dropped_without_rejection`` (must be
    0)."""
    accounted = (stats["completed"] + stats["failed"]
                 + stats["rejected_full"] + stats["rejected_shutdown"]
                 + stats["rejected_failure"] + stats["shed_deadline"]
                 + stats["shed_brownout"])
    return int(stats["submitted"] - accounted - stats.get("in_flight", 0))


def run_scenario(spec: ScenarioSpec, sched, *,
                 scale: Optional[float] = None,
                 injector=None,
                 result_timeout_s: float = 300.0) -> Dict[str, object]:
    """Drive ``sched`` (Scheduler-compatible: ``submit``/``stats``)
    through the scenario; returns per-class metrics + counters.

    The caller owns the scheduler's lifecycle (and its injector —
    pass the same object here so ``arm()`` starts the fault clock at
    trace start).  Open-loop replays the scripted arrivals on the wall
    clock; closed-loop partitions the event stream round-robin across
    ``n_clients`` client threads that issue-on-completion with
    ``think_s`` pauses (the scripted ``t_arrival`` then only orders a
    client's stream — pressure comes from the client loop)."""
    events = build_trace(spec, scale=scale)
    per_class: Dict[str, _ClassStats] = {c: _ClassStats()
                                         for c in SLO_CLASSES}
    lock = threading.Lock()
    futures: List[object] = []

    def track(ev: TraceEvent, fut, t_submit: float) -> None:
        def done(f):
            now = time.monotonic()
            cs = per_class[ev.slo]
            try:
                f.result(0)
            except RequestRejected:
                with lock:
                    cs.rejected += 1
                return
            except BaseException:              # noqa: BLE001
                with lock:
                    cs.failed += 1
                return
            lat = now - t_submit
            with lock:
                cs.completed += 1
                cs.latencies.append(lat)
                if ev.deadline_s is None or lat <= ev.deadline_s:
                    cs.deadline_met += 1
        fut.add_done_callback(done)
        futures.append(fut)

    if injector is not None:
        injector.arm()
    t0 = time.monotonic()

    if not spec.closed_loop:
        for ev in events:
            wait = ev.t_arrival - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(wait)
            ts = time.monotonic()
            fut = sched.submit(ev.workload, event_payload(spec, ev),
                               deadline=ev.deadline_s,
                               slo_class=ev.slo)
            track(ev, fut, ts)
    else:
        streams: List[List[TraceEvent]] = [
            [] for _ in range(max(int(spec.n_clients), 1))]
        for i, ev in enumerate(events):
            streams[i % len(streams)].append(ev)

        def client(stream: List[TraceEvent]) -> None:
            for ev in stream:
                ts = time.monotonic()
                fut = sched.submit(ev.workload, event_payload(spec, ev),
                                   deadline=ev.deadline_s,
                                   slo_class=ev.slo)
                track(ev, fut, ts)
                try:
                    # issue-on-completion: the next request waits for
                    # this one's verdict (value OR rejection), then
                    # thinks — arrivals now depend on completions
                    fut.exception(result_timeout_s)
                except TimeoutError:
                    pass
                if spec.think_s > 0:
                    time.sleep(spec.think_s)

        threads = [threading.Thread(target=client, args=(s,),
                                    name=f"scenario-client-{i}")
                   for i, s in enumerate(streams)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    # every future must reach a verdict before metrics mean anything
    deadline = time.monotonic() + result_timeout_s
    for fut in futures:
        try:
            fut.exception(max(deadline - time.monotonic(), 0.01))
        except TimeoutError:
            pass
    elapsed = max(time.monotonic() - t0, 1e-9)

    stats = sched.stats.snapshot()
    stats["in_flight"] = sched.stats.in_flight
    out: Dict[str, object] = {
        "scenario": spec.name,
        "mode": "closed" if spec.closed_loop else "open",
        "n_events": len(events),
        "elapsed_s": elapsed,
        "digest": trace_digest(events),
        "counters": stats,
        "dropped_without_rejection": accounting_invariant(stats),
        "classes": {},
    }
    with lock:
        for cls_name, cs in per_class.items():
            if not (cs.completed or cs.rejected or cs.failed):
                continue
            out["classes"][cls_name] = {
                "completed": cs.completed,
                "rejected": cs.rejected,
                "failed": cs.failed,
                "p50_s": cs.quantile(0.50),
                "p95_s": cs.quantile(0.95),
                # goodput: only deadline-met completions count for
                # deadline-carrying classes
                "goodput_rps": cs.deadline_met / elapsed,
            }
    return out
