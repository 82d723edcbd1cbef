"""Work sharing — the paper's first solution methodology (§1, §5.4.3).

The paper's 2-device rule: with GPU-alone runtime T_GPU and CPU-alone
runtime T_CPU, give the CPU a share of T_GPU / (T_GPU + T_CPU).  We
generalize to N device groups via throughputs (thr_i = 1/T_i per work
unit): share_i = thr_i / sum(thr), then refine for communication and
post-processing exactly like the paper's empirical loop.

Work units here are whatever the caller chooses: image rows (Conv),
matrix rows (spmv), micro-batches (LM training — see train.trainer).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


def paper_split(t_gpu: float, t_cpu: float) -> float:
    """§5.4.3: the share of work the *CPU* (slower device) should take."""
    return t_gpu / (t_gpu + t_cpu)


def proportional_shares(throughputs: Sequence[float]) -> np.ndarray:
    thr = np.asarray(throughputs, dtype=np.float64)
    if np.any(thr < 0):
        raise ValueError("negative throughput")
    s = thr.sum()
    if s <= 0:
        raise ValueError("all-zero throughputs")
    return thr / s


def integer_shares(total_units: int, throughputs: Sequence[float],
                   min_units: int = 0) -> List[int]:
    """Split ``total_units`` work units proportionally to throughput
    (largest-remainder rounding). Groups with zero throughput get 0.

    ``min_units`` is clamped to what is actually feasible
    (total_units // n_live): an infeasible minimum used to drive the
    repair loop into over-allocation (no group above the floor to take
    units back from), spinning forever."""
    shares = proportional_shares(throughputs)
    live = [i for i, t in enumerate(throughputs) if t > 0]
    raw = shares * total_units
    base = np.floor(raw).astype(int)
    eff_min = 0
    if min_units > 0 and live:
        eff_min = min(int(min_units), total_units // len(live))
        for i in live:
            if base[i] < eff_min:
                base[i] = eff_min
    rem = int(total_units - base.sum())
    if rem > 0:
        # hand out by largest fractional remainder — live groups only,
        # so a zero-throughput group can never be topped up
        frac = raw - np.floor(raw)
        order = sorted(live, key=lambda i: -frac[i])
        for j in range(rem):
            base[order[j % len(order)]] += 1
    elif rem < 0:
        # take back from the largest allocation still above the floor;
        # feasible eff_min guarantees sum(floors) <= total so this
        # terminates without dipping below the minimum
        while rem < 0:
            cand = [i for i in live if base[i] > eff_min]
            if not cand:                      # defensive: floor everywhere
                cand = [i for i in live if base[i] > 0]
            if not cand:
                break
            j = max(cand, key=lambda i: base[i])
            take = min(int(base[j]) - (eff_min if base[j] > eff_min
                                       else 0), -rem)
            take = max(take, 1)
            base[j] -= take
            rem += take
    assert base.sum() == total_units, (base, total_units)
    return [int(b) for b in base]


@dataclass(frozen=True)
class WorkPlan:
    """A work-sharing plan + the paper's §5.1 metrics, analytic."""
    units: List[int]                 # work units per group
    throughputs: List[float]         # units/sec per group
    comm_cost: float                 # un-hidden communication time (sec)
    post_cost: float                 # merge/post-processing time (sec)
    group_times: List[float]         # k_i / thr_i
    hybrid_time: float               # max_i group_time + comm + post
    best_single_time: float          # total / max(thr)
    gain: float                      # paper "gain": improvement over best single
    idle_fracs: List[float]          # per-group idle fraction
    resource_efficiency: float       # 1 - mean(idle)

    def summary(self) -> str:
        return (f"units={self.units} hybrid={self.hybrid_time:.4g}s "
                f"single={self.best_single_time:.4g}s gain={100*self.gain:.1f}% "
                f"idle={[f'{100*i:.1f}%' for i in self.idle_fracs]}")


def _evaluate(units, throughputs, comm_cost, post_cost):
    thr = [max(t, 1e-12) for t in throughputs]
    gt = [u / t for u, t in zip(units, thr)]
    span = max(gt) if gt else 0.0
    # communication/post only charged when work is actually split
    split = sum(1 for u in units if u > 0) > 1
    hybrid = span + (comm_cost + post_cost if split else 0.0)
    return gt, hybrid


def plan_work(total_units: int, throughputs: Sequence[float],
              comm_cost: float = 0.0, post_cost: float = 0.0,
              min_units: int = 0) -> WorkPlan:
    """Proportional integer plan — with the paper's sanity rule: if the
    rounded hybrid plan loses to the best single device (integer
    granularity or communication overhead), fall back to single-device
    (hybrid only when it pays, §5.3.1)."""
    thr = [max(t, 1e-12) for t in throughputs]
    units = integer_shares(total_units, throughputs, min_units)
    gt, hybrid = _evaluate(units, throughputs, comm_cost, post_cost)
    # candidate: everything on the fastest group
    fast = int(np.argmax(thr))
    solo = [0] * len(thr)
    solo[fast] = total_units
    gt_s, hybrid_s = _evaluate(solo, throughputs, comm_cost, post_cost)
    if hybrid_s < hybrid:
        units, gt, hybrid = solo, gt_s, hybrid_s
    single = total_units / max(thr)
    gain = (single - hybrid) / single if single > 0 else 0.0
    denom = max(hybrid, 1e-12)
    idle = [(hybrid - g) / denom for g in gt]
    eff = 1.0 - float(np.mean(idle)) if idle else 1.0
    return WorkPlan(units=list(units), throughputs=list(throughputs),
                    comm_cost=comm_cost, post_cost=post_cost, group_times=gt,
                    hybrid_time=hybrid, best_single_time=single, gain=gain,
                    idle_fracs=idle, resource_efficiency=eff)


def refine_split(total_units: int, measured_times: Sequence[float],
                 current_units: Sequence[int]) -> List[int]:
    """The paper's empirical refinement: re-plan from *measured* per-group
    times of the last execution (§5.4.3 'adjust it experimentally')."""
    thr = [u / t if t > 0 else 0.0
           for u, t in zip(current_units, measured_times)]
    if all(t == 0 for t in thr):
        return list(current_units)
    return integer_shares(total_units, thr)
