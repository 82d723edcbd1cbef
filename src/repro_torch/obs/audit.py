"""Placement audit: projected vs actual spans, per-lane utilization.

The scheduler's cost model projects an execution span for every
placement decision (``PlacementDecision.est_exec_s`` plus the scored
alternatives it rejected).  This accumulator closes the loop: the
dispatch path ``record()``s the projection, the resolve path
``stamp()``s the measured service time, and ``summary()`` exposes the
error distribution per (workload, decision-kind) — the number that
tells you whether a p95 regression is the cost model lying or the
lanes genuinely contended.

Per-lane busy time accrues via ``lane_busy()``; ``summary()`` turns it
into busy/idle fractions over the audit window and a single
``resource_efficiency`` figure (mean busy fraction across lanes — the
paper's §6 metric: how much of the provisioned silicon did useful
work).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class PlacementAudit:
    """Thread-safe projected-vs-actual accumulator."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._t_open = clock()
        # req_id -> (workload, kind, projected_s, alternatives)
        self._pending: Dict[object, Tuple[str, str, float, dict]] = {}
        # (workload, kind) -> list of (projected_s, actual_s)
        self._closed: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
        self._lane_busy_s: Dict[str, float] = {}

    def record(self, req_id, workload: str, kind: str,
               projected_s: float, alternatives: Optional[dict] = None
               ) -> None:
        """Dispatch path: a placement decision was made for ``req_id``."""
        with self._lock:
            self._pending[req_id] = (workload, kind, float(projected_s),
                                     dict(alternatives or {}))

    def stamp(self, req_id, actual_s: float) -> None:
        """Resolve path: the request's measured service time."""
        with self._lock:
            rec = self._pending.pop(req_id, None)
            if rec is None:
                return              # rejected/shed before dispatch
            workload, kind, projected_s, _ = rec
            self._closed.setdefault((workload, kind), []).append(
                (projected_s, float(actual_s)))

    def lane_busy(self, lane: str, busy_s: float) -> None:
        """Accrue ``busy_s`` seconds of execution time to ``lane``."""
        with self._lock:
            self._lane_busy_s[lane] = (self._lane_busy_s.get(lane, 0.0)
                                       + float(busy_s))

    def summary(self) -> dict:
        """Error distributions + utilization over the audit window."""
        now = self._clock()
        with self._lock:
            elapsed = max(now - self._t_open, 1e-9)
            per_key = {}
            for (workload, kind), pairs in self._closed.items():
                abs_err = [abs(a - p) for p, a in pairs]
                rel_err = [abs(a - p) / max(a, 1e-9) for p, a in pairs]
                per_key[f"{workload}:{kind}"] = {
                    "n": len(pairs),
                    "mean_abs_err_s": sum(abs_err) / len(abs_err),
                    "mean_rel_err": sum(rel_err) / len(rel_err),
                    "max_rel_err": max(rel_err),
                }
            util = {lane: min(busy / elapsed, 1.0)
                    for lane, busy in self._lane_busy_s.items()}
            eff = (sum(util.values()) / len(util)) if util else 0.0
            return {"window_s": elapsed, "placements": per_key,
                    "lane_utilization": util,
                    "resource_efficiency": eff,
                    "open_decisions": len(self._pending)}

    def reset(self) -> None:
        with self._lock:
            self._t_open = self._clock()
            self._pending.clear()
            self._closed.clear()
            self._lane_busy_s.clear()
