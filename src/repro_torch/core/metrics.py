"""The paper's §5.1 evaluation metrics: gain and idle time.

gain       = (best single-device time - hybrid time) / best single time
idle_i     = fraction of the hybrid makespan device i spent not computing
efficiency = 1 - mean(idle)          (paper reports ~90% on average)

``EWMA`` is the thread-safe moving average the executors' telemetry
uses.  The serving counters (``ServeStats``, ``FleetStats``,
``Percentile``) come with the serving port.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict


class EWMA:
    """Thread-safe exponentially weighted moving average (load
    telemetry: queue depth, wait, service time)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._value = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        with self._lock:
            self._value = (x if self._n == 0
                           else self.alpha * x
                           + (1 - self.alpha) * self._value)
            self._n += 1

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def n(self) -> int:
        with self._lock:
            return self._n



@dataclass(frozen=True)
class HybridResult:
    workload: str
    hybrid_time: float               # MEASURED makespan (+comm+merge)
    single_times: Dict[str, float]   # device-group name -> alone time
    busy_times: Dict[str, float]     # device-group name -> busy during hybrid
    analytic_time: float = 0.0       # model makespan from the WorkPlan
    steals: int = 0                  # chunks moved by work stealing
    n_chunks: int = 0
    mode: str = ""                   # "threads" | "virtual" | "sequential"
    # overlap model evaluated with THIS run's observed per-unit times:
    # checks the paper's max(t_fast, t_slow) + comm *structure* without
    # the planning-EWMA's sensitivity to machine-speed drift
    analytic_observed_time: float = 0.0

    @property
    def model_agreement(self) -> float:
        """|measured - analytic| / analytic (0 when no analytic time)."""
        if self.analytic_time <= 0:
            return 0.0
        return abs(self.hybrid_time - self.analytic_time) / self.analytic_time

    @property
    def overlap_agreement(self) -> float:
        """|measured - observed-throughput model| / model."""
        if self.analytic_observed_time <= 0:
            return 0.0
        return (abs(self.hybrid_time - self.analytic_observed_time)
                / self.analytic_observed_time)

    @property
    def best_single(self) -> float:
        return min(self.single_times.values())

    @property
    def best_single_device(self) -> str:
        return min(self.single_times, key=self.single_times.get)

    @property
    def gain(self) -> float:
        return (self.best_single - self.hybrid_time) / self.best_single

    @property
    def idle_fracs(self) -> Dict[str, float]:
        return {d: max(0.0, (self.hybrid_time - b) / self.hybrid_time)
                for d, b in self.busy_times.items()}

    @property
    def resource_efficiency(self) -> float:
        idle = self.idle_fracs
        return 1.0 - sum(idle.values()) / len(idle) if idle else 1.0

    def row(self) -> str:
        idle = self.idle_fracs
        worst = max(idle.values()) if idle else 0.0
        extra = ""
        if self.analytic_time > 0:
            extra = (f"  model={self.analytic_time * 1e3:9.3f}ms "
                     f"(±{100 * self.model_agreement:.0f}%)")
        if self.steals:
            extra += f"  steals={self.steals}"
        return (f"{self.workload:8s} gain={100 * self.gain:6.1f}%  "
                f"idle={100 * worst:5.1f}%  "
                f"eff={100 * self.resource_efficiency:5.1f}%  "
                f"hybrid={self.hybrid_time * 1e3:9.3f}ms  "
                f"best-single[{self.best_single_device}]="
                f"{self.best_single * 1e3:9.3f}ms" + extra)
