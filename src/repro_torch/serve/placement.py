"""Cost-model-driven placement for the serving scheduler.

Per request the scheduler must answer the fleet-level version of the
paper's question: *dedicate* a device group (run the whole request on
the group with the earliest projected completion — co-scheduling two
different requests on two groups), *work-share* it across all groups
(the paper's §5.4.3 split — only when the projected makespan win
exceeds the split's overhead), or leave it *queued* behind the lane it
was placed on (the projected-free-time model makes queueing implicit:
a placement whose start time is in the future IS a queued placement).

The inputs are per-group seconds/unit estimates resolved by the
scheduler from the PR-3 calibration cache or cost-model priors
(Lee et al.: per-kernel device affinity varies 2.5-14x — exactly the
spread this arbitration exploits), and per-group ``busy_until``
projections maintained from the same estimates as work is enqueued.
All pure functions over plain data: no devices, no threads, so the
policy is exhaustively testable with fake clocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import work_sharing

DEDICATED = "dedicated"
SHARED = "shared"


@dataclass
class GroupLoad:
    """One device group as the placement policy sees it."""
    name: str
    unit_time: Optional[float]       # sec/unit for THIS workload (None =
    #                                  no calibration and no model prior)
    busy_until: float = 0.0          # projected lane-free time (monotonic)
    alive: bool = True


@dataclass(frozen=True)
class PlacementDecision:
    kind: str                        # DEDICATED | SHARED
    groups: List[str]                # lanes the request will occupy
    t_start: float                   # projected start (>= now if queued)
    t_finish: float                  # projected completion
    est_exec_s: float                # projected execution span
    queued_behind_s: float = 0.0     # how long the lane backlog delays it
    alternatives: Dict[str, float] = field(default_factory=dict)

    @property
    def queued(self) -> bool:
        return self.queued_behind_s > 1e-9


def _unit_time(g: GroupLoad, fallback: float) -> float:
    return g.unit_time if (g.unit_time and g.unit_time > 0) else fallback


def _contended_finish(start: float, span: float, others_busy_until: float,
                      contention: float) -> float:
    """Projected finish of a dedicated span that overlaps other lanes'
    busy windows on a host with limited cross-lane headroom.

    While at least one other lane is projected busy (until
    ``others_busy_until``) this lane only progresses at ``1/contention``
    of its solo rate — the same measured pairwise headroom that prices
    the shared candidate (``contention = 2/concurrency_capacity``).
    Once the other lanes drain, the remaining work runs at full rate.
    ``contention <= 1`` (real parallel headroom) is the old projection.
    """
    if contention <= 1.0 + 1e-12 or others_busy_until <= start + 1e-12:
        return start + span
    contended_window = others_busy_until - start
    if span * contention <= contended_window:
        return start + span * contention
    done_contended = contended_window / contention    # units-of-span done
    return others_busy_until + (span - done_contended)


def plan_placement(n_units: int, groups: List[GroupLoad], now: float,
                   split_overhead_s: float = 0.0,
                   allow_shared: bool = True,
                   shared_span_factor: float = 1.0,
                   contention_factor: float = 1.0
                   ) -> Optional[PlacementDecision]:
    """Choose the placement with the earliest projected completion.

    Dedicated candidates: each alive group finishes at
    ``max(now, busy_until) + n_units * unit_time``.  The shared
    candidate starts when *every* group is free (work sharing occupies
    all lanes), runs for the §5.4.3 proportional-split makespan scaled
    by ``shared_span_factor``, and pays ``split_overhead_s`` (dispatch
    + merge + comm) on top — so a split is chosen exactly when its
    makespan win exceeds its overhead, never "because hybrid".
    ``shared_span_factor`` prices in the platform's measured
    cross-lane headroom (overlap_check's ``concurrency_capacity``):
    1.0 trusts the perfect-overlap model; on a low-core host where two
    pinned lanes deliver ~1x one lane's throughput, ``2/capacity`` ~2
    makes the shared candidate honestly unattractive.
    ``contention_factor`` applies that same measured headroom to
    *dedicated* candidates: a span co-scheduled while other lanes are
    projected busy runs slowed by the factor until they drain — on a
    no-headroom host two "parallel" dedicated lanes are contention,
    and pretending otherwise under-projects every busy_until, admits
    deadline-infeasible work and mis-ranks dedicated vs queued.
    Groups with no estimate fall back to the mean of the known
    estimates (or 1.0) — probe-only planning then corrects them after
    the first execution.  Returns None when no group is alive."""
    alive = [g for g in groups if g.alive]
    if not alive:
        return None
    known = [g.unit_time for g in alive if g.unit_time and g.unit_time > 0]
    fallback = (sum(known) / len(known)) if known else 1.0
    n_units = max(int(n_units), 1)

    scores: Dict[str, float] = {}
    best: Optional[PlacementDecision] = None
    for g in alive:
        start = max(now, g.busy_until)
        span = n_units * _unit_time(g, fallback)
        others_busy = max([o.busy_until for o in alive if o is not g],
                          default=now)
        finish = _contended_finish(start, span, others_busy,
                                   contention_factor)
        scores[f"dedicated:{g.name}"] = finish
        cand = PlacementDecision(
            DEDICATED, [g.name], start, finish, finish - start,
            queued_behind_s=start - now)
        if best is None or cand.t_finish < best.t_finish:
            best = cand

    # The shared candidate is a *latency* optimization for idle lanes:
    # under backlog, occupying every lane to split ONE request forfeits
    # co-scheduling different requests on different lanes — which beats
    # any split on throughput (a split can at best halve one request's
    # span; co-scheduling doubles the stream's).  Measured: allowing
    # splits under a 2.5x-capacity backlog dropped scheduler throughput
    # 74->45 rps and p95 2x behind FIFO; idle-only splits win 2.6x.
    idle = all(g.busy_until <= now + 1e-9 for g in alive)
    if allow_shared and idle and len(alive) >= 2:
        start = max([now] + [g.busy_until for g in alive])
        thr = [1.0 / _unit_time(g, fallback) for g in alive]
        plan = work_sharing.plan_work(n_units, thr)
        # plan_work falls back to single-device when the integer split
        # loses; a degenerate "shared" plan that uses one group is just
        # a worse dedicated placement — skip it
        if sum(1 for u in plan.units if u > 0) >= 2:
            span = (plan.hybrid_time * max(shared_span_factor, 1e-9)
                    + split_overhead_s)
            finish = start + span
            scores["shared"] = finish
            if finish < best.t_finish:
                best = PlacementDecision(
                    SHARED, [g.name for g in alive], start, finish, span,
                    queued_behind_s=start - now)

    return PlacementDecision(best.kind, best.groups, best.t_start,
                             best.t_finish, best.est_exec_s,
                             best.queued_behind_s, alternatives=scores)


@dataclass(frozen=True)
class DisaggregationPlan:
    """Phase-to-lane assignment for a two-phase workload (the paper's
    §5.4.3 suitability split applied to LM serving): compute-bound
    prefill on one lane, bandwidth-bound decode on another."""
    prefill_group: str
    decode_group: str
    est_prefill_s: float
    est_decode_s: float
    alternatives: Dict[str, float] = field(default_factory=dict)

    @property
    def disaggregated(self) -> bool:
        return self.prefill_group != self.decode_group


def plan_disaggregation(groups: List[GroupLoad],
                        prefill_times: Dict[str, float],
                        decode_times: Dict[str, float]
                        ) -> Optional[DisaggregationPlan]:
    """Assign prefill and decode lanes from per-group phase estimates.

    Prefill goes to the group with the smallest projected prefill time
    (it is compute-bound, so this is the fastest-matmul lane); the
    decode step-loop is co-scheduled on the best *other* lane so new
    arrivals' prefills never stall the running batch.  With one alive
    group both phases share it.  Pure function over plain estimates —
    the scheduler resolves ``prefill_times``/``decode_times`` from
    ``CostTerms`` priors scaled by group slowdown, so a fresh process
    places with zero probe runs."""
    alive = [g for g in groups if g.alive]
    if not alive:
        return None
    inf = float("inf")
    pre = min(alive, key=lambda g: prefill_times.get(g.name, inf))
    others = [g for g in alive if g.name != pre.name]
    dec = (min(others, key=lambda g: decode_times.get(g.name, inf))
           if others else pre)
    scores = {f"prefill:{g.name}": prefill_times.get(g.name, inf)
              for g in alive}
    scores.update({f"decode:{g.name}": decode_times.get(g.name, inf)
                   for g in alive})
    return DisaggregationPlan(
        pre.name, dec.name,
        est_prefill_s=prefill_times.get(pre.name, 0.0),
        est_decode_s=decode_times.get(dec.name, 0.0),
        alternatives=scores)


def degraded_fraction(groups: List[GroupLoad]) -> float:
    """Fraction of lanes currently dead — the brownout intensity
    signal.  0.0 is a healthy fleet; anything above it switches the
    scheduler's admission to degraded mode (shed best-effort work
    first, stop lingering for batch coalescing) so a lane death
    degrades service smoothly instead of collapsing the queue.  Pure
    function so degradation policy is testable without threads."""
    if not groups:
        return 0.0
    dead = sum(1 for g in groups if not g.alive)
    return dead / len(groups)


def deadline_feasible(decision: PlacementDecision, now: float,
                      t_deadline: Optional[float]) -> bool:
    """Admission check: can the chosen placement still make the
    deadline?  (Shedding here, before device time is spent, is what
    keeps an overloaded scheduler's useful throughput flat instead of
    collapsing into all-late work.)"""
    if t_deadline is None:
        return True
    return decision.t_finish <= t_deadline
