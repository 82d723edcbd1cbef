"""Throughput calibration: static (roofline) and online (EWMA telemetry).

The paper obtains work shares "empirically by studying the time taken by
the CPU and the GPU individually" (§4.5).  At cluster scale that
measurement must be continuous: per-group step times feed an EWMA which
re-plans shares when drift exceeds a threshold — this is the straggler
mitigation path used by train.trainer.

Steady-state calls must not pay for calibration again: the process-wide
``CalibrationCache`` remembers seconds/unit per (workload, group) key,
so an executor created for a workload it has seen before skips the
probe runs entirely and ``run_work_shared`` executes each chunk exactly
once (no warmup, no min-of-N re-execution).

The cache is also *persistent* (JSON store shared with the hardware
profile, ``REPRO_CALIB_CACHE``, with the merge-on-write contract of
``core/persist.py``): a brand-new process finds the previous process's
measured unit times on disk and plans its first work-shared call with
zero probe runs.  Disk-loaded entries are marked ``in_process=False``
so the executor still warms the chunk shapes once per process — warmth
is a property of the process, calibration of the box.

The port keys its persisted entries ``torch:cuda`` (a platform whose
accel group is a GPU) or ``torch:cpu``, never a JAX backend name, so
it cannot feed the reference's planner from a shared store file.
"""
from __future__ import annotations

import atexit
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.persist import JsonStore, default_calib_path
from repro_torch.kernels.common import sync

_MIN_UNIT_TIME = 1e-9


@dataclass
class GroupStats:
    ewma_unit_time: float = 0.0      # seconds per work unit
    n_obs: int = 0
    last_time: float = 0.0
    alive: bool = True


class ThroughputTracker:
    """EWMA throughput per device group + drift detection."""

    def __init__(self, groups: Sequence[str], alpha: float = 0.25,
                 drift_threshold: float = 0.15):
        self.alpha = alpha
        self.drift_threshold = drift_threshold
        self.stats: Dict[str, GroupStats] = {g: GroupStats() for g in groups}
        self._planned_thr: Optional[List[float]] = None

    def reset(self) -> None:
        """Forget calibration history (e.g. between workload phases with
        different per-unit cost profiles)."""
        for g in self.stats:
            alive = self.stats[g].alive
            self.stats[g] = GroupStats(alive=alive)
        self._planned_thr = None

    def seed(self, group: str, unit_time: float) -> None:
        """Install a known seconds/unit (e.g. from the calibration
        cache) as if it had been measured once."""
        s = self.stats[group]
        s.ewma_unit_time = max(unit_time, _MIN_UNIT_TIME)
        s.n_obs = max(s.n_obs, 1)

    def update(self, group: str, units: int, elapsed: float) -> None:
        s = self.stats[group]
        if units <= 0:
            return
        per_unit = max(elapsed / units, _MIN_UNIT_TIME)
        if s.n_obs == 0:
            s.ewma_unit_time = per_unit
        else:
            s.ewma_unit_time = (self.alpha * per_unit
                                + (1 - self.alpha) * s.ewma_unit_time)
        s.n_obs += 1
        s.last_time = elapsed

    def mark_dead(self, group: str) -> None:
        self.stats[group].alive = False

    def mark_alive(self, group: str) -> None:
        self.stats[group].alive = True

    def throughputs(self, groups: Optional[Sequence[str]] = None
                    ) -> List[float]:
        gs = groups or list(self.stats)
        out = []
        for g in gs:
            s = self.stats[g]
            if not s.alive:
                out.append(0.0)
            elif s.n_obs == 0 or s.ewma_unit_time <= 0:
                out.append(1.0)  # uncalibrated: assume unit throughput
            else:
                out.append(1.0 / s.ewma_unit_time)
        return out

    def should_replan(self) -> bool:
        """True when current EWMA deviates from the throughputs used for
        the last plan by more than the drift threshold (stragglers!)."""
        cur = self.throughputs()
        if self._planned_thr is None:
            self._planned_thr = cur
            return True
        for a, b in zip(cur, self._planned_thr):
            if b == 0 and a > 0:
                return True
            if b > 0 and abs(a - b) / b > self.drift_threshold:
                return True
        return False

    def mark_planned(self) -> None:
        self._planned_thr = self.throughputs()


def measure(fn: Callable[[], object], warmup: int = 1, iters: int = 3,
            reduce: str = "mean") -> float:
    """Wall-clock a callable, forcing completion of whatever it returns.

    CUDA launches are asynchronous: without synchronising the device of
    every tensor *returned* this would time the launch, not the
    execution, and every work-sharing plan downstream would be skewed
    toward whichever group launches fastest.

    ``reduce="mean"`` (calibration: expected steady-state cost) or
    ``"min"`` (autotune search: best-case ranking is robust to noise
    from other timers/threads on a shared box).

    ``warmup=0`` is the pure-cold mode (the cold-start benchmark times
    the *first* call, kernel build included); ``iters`` is clamped to
    at least 1 so ``warmup=0, iters=1`` can never divide by zero."""
    iters = max(int(iters), 1)
    for _ in range(max(int(warmup), 0)):
        sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return min(times) if reduce == "min" else sum(times) / len(times)


# ---------------------------------------------------------------------------
# Persistent per-(workload, group) calibration
# ---------------------------------------------------------------------------
@dataclass
class _CacheEntry:
    unit_time: float                 # EWMA seconds per work unit
    n_obs: int = 1
    in_process: bool = True          # measured in THIS process (vs disk)
    t_obs: float = 0.0               # wall-clock time of last observation


_CALIB_SECTION = "unit_times"


class CalibrationCache:
    """Process-wide seconds/unit memory, keyed by
    (workload, group, slowdown).  The slowdown is part of the key so
    simulated platforms with different throughput ratios (Hybrid-High
    vs Hybrid-Low) never share entries; ``backend`` (``torch:cuda``,
    ``torch:cuda:simulated`` or ``torch:cpu``) names the persisted
    section.

    Backed by a JSON store (section ``unit_times``, keyed per backend)
    with the tune cache's merge-on-write / atomic-replace / corrupt-file
    tolerance contract, so a fresh process starts from the previous
    process's measured unit times and plans without probe runs.  Only
    unit times persist: sticky plans are derived state, and entries
    loaded from disk are flagged ``in_process=False`` so the
    per-process warmup still happens exactly once."""

    # deferred-flush window for updates to already-persisted keys
    FLUSH_INTERVAL_S = 2.0

    def __init__(self, alpha: float = 0.25, path: Optional[str] = "auto",
                 backend: str = "torch:cpu"):
        self.alpha = alpha
        self._store: Dict[Tuple[str, str, float], _CacheEntry] = {}
        self._plans: Dict[str, Tuple[int, int, List[int]]] = {}
        self._lock = threading.Lock()
        self._disk = JsonStore(default_calib_path() if path == "auto"
                               else path)
        self._disk_loaded = False
        self._backend = backend
        self._dirty = False
        self._last_flush = 0.0

    @staticmethod
    def key(workload: str, group: str, slowdown: float = 1.0
            ) -> Tuple[str, str, float]:
        return (workload, group, round(float(slowdown), 6))

    @staticmethod
    def _json_key(k: Tuple[str, str, float]) -> str:
        return "\t".join((k[0], k[1], f"{k[2]:g}"))

    def _backend_name(self) -> str:
        return self._backend

    def _load_disk(self) -> None:
        """Merge persisted unit times (for this backend) into memory as
        ``in_process=False`` entries; in-memory measurements win."""
        if self._disk_loaded:
            return
        self._disk_loaded = True
        if not self._disk.path:
            return
        with self._disk.lock:
            section = self._disk.data().get(_CALIB_SECTION, {})
        entries = section.get(self._backend_name(), {})
        if not isinstance(entries, dict):
            return
        for jk, e in entries.items():
            parts = jk.split("\t")
            if len(parts) != 3 or not isinstance(e, dict):
                continue
            try:
                k = self.key(parts[0], parts[1], float(parts[2]))
                t = float(e["t"])
                n = int(e.get("n", 1))
                # entries persisted before timestamps existed count as
                # freshly observed: they will be replaced by the first
                # in-process measurement anyway, and treating them as
                # infinitely stale would discard real affinity data
                ts = float(e.get("ts", time.time()))
            except (ValueError, KeyError, TypeError):
                continue
            if k not in self._store:
                self._store[k] = _CacheEntry(max(t, _MIN_UNIT_TIME),
                                             n_obs=max(n, 1),
                                             in_process=False,
                                             t_obs=ts)

    def _flush_locked(self) -> None:
        if not self._disk.path or not self._dirty:
            return
        self._dirty = False
        self._last_flush = time.monotonic()
        with self._disk.lock:
            dest = self._disk.data().setdefault(
                _CALIB_SECTION, {}).setdefault(self._backend_name(), {})
            for k, e in self._store.items():
                dest[self._json_key(k)] = {"t": e.unit_time, "n": e.n_obs,
                                           "ts": e.t_obs}
            self._disk.flush()

    def flush(self) -> None:
        """Persist any deferred updates now (atexit hook; also safe to
        call explicitly, e.g. before handing the store to another
        process)."""
        with self._lock:
            self._flush_locked()

    def get(self, workload: str, group: str, slowdown: float = 1.0
            ) -> Optional[float]:
        with self._lock:
            self._load_disk()
            e = self._store.get(self.key(workload, group, slowdown))
            return e.unit_time if e else None

    def get_decayed(self, workload: str, group: str,
                    slowdown: float = 1.0,
                    peers: Sequence[Tuple[str, float]] = (),
                    tau_s: float = 0.0,
                    now: Optional[float] = None) -> Optional[float]:
        """Age-weighted estimate for *placement*: the raw entry shrunk
        toward the cross-group mean as it goes stale.

        A lane whose cached estimate says "slow" gets no traffic, so
        the estimate never refreshes — with exploration disabled (or
        between exploration windows) it would starve forever.  Here the
        estimate's weight decays exponentially with its age
        (``exp(-age / tau_s)``) and the lost weight shifts to the mean
        of the OTHER lanes' estimates for this workload (``peers`` is
        the other lanes as ``(group, slowdown)`` pairs): a fully stale
        entry carries no information about this lane anymore, so the
        best remaining guess is the workload's intrinsic cost as the
        lanes still serving it measure it — the stale-slow lane drifts
        back to parity, wins traffic again on its own, and the fresh
        measurement then replaces the estimate entirely.  ``tau_s <=
        0`` disables decay (returns the raw entry); no peers means
        nothing to shrink toward (raw entry); a missing entry still
        returns ``None`` so cost-model priors keep their role.  The
        raw entry itself is never modified — executions that measure
        the lane reset its age through ``put``."""
        with self._lock:
            self._load_disk()
            e = self._store.get(self.key(workload, group, slowdown))
            if e is None:
                return None
            if tau_s <= 0:
                return e.unit_time
            peer_vals = []
            for pg, pslow in peers:
                pe = self._store.get(self.key(workload, pg, pslow))
                if pe is not None:
                    peer_vals.append(pe.unit_time)
            if not peer_vals:
                return e.unit_time
            if now is None:
                now = time.time()
            age = max(now - e.t_obs, 0.0)
            w = math.exp(-age / max(tau_s, 1e-9))
            target = sum(peer_vals) / len(peer_vals)
            return w * e.unit_time + (1.0 - w) * target

    def warmed_in_process(self, workload: str, group: str,
                          slowdown: float = 1.0) -> bool:
        """True when this entry was measured in THIS process — i.e. the
        chunk shapes behind it are already warm here.  A disk-loaded
        entry calibrates the plan but must not skip the per-process
        warmup."""
        with self._lock:
            self._load_disk()
            e = self._store.get(self.key(workload, group, slowdown))
            return bool(e and e.in_process)

    def put(self, workload: str, group: str, unit_time: float,
            slowdown: float = 1.0) -> None:
        """A NEW key flushes immediately (it is what lets a fresh
        process plan without probes); EWMA refinements of existing
        keys — the per-call steady-state case — defer to the debounce
        window + atexit so benchmark-timed paths stay free of file
        I/O."""
        unit_time = max(unit_time, _MIN_UNIT_TIME)
        k = self.key(workload, group, slowdown)
        t_now = time.time()
        with self._lock:
            self._load_disk()
            e = self._store.get(k)
            fresh = e is None
            if fresh:
                self._store[k] = _CacheEntry(unit_time, t_obs=t_now)
            elif not e.in_process:
                # first in-process measurement REPLACES a disk-loaded
                # value instead of EWMA-blending into it: another
                # process's history may have been measured under
                # contention or on different machine state, and a
                # stale-slow estimate that only decays by alpha per
                # observation starves the group for many calls (the
                # serving scheduler routes by these numbers)
                e.unit_time = unit_time
                e.n_obs += 1
                e.in_process = True
                e.t_obs = t_now
            else:
                e.unit_time = (self.alpha * unit_time
                               + (1 - self.alpha) * e.unit_time)
                e.n_obs += 1
                e.t_obs = t_now
            self._dirty = True
            if fresh or (time.monotonic() - self._last_flush
                         >= self.FLUSH_INTERVAL_S):
                self._flush_locked()

    def mark_group_stale(self, group: str,
                         age_s: Optional[float] = None) -> None:
        """Age every entry of ``group`` as if it were observed
        ``age_s`` seconds earlier (default: fully stale, epoch-old).

        The serving scheduler calls this on lane death: whatever the
        lane measured before it died says nothing about the lane that
        comes back (a wedged kernel, a thermal event, a recovered
        process all change its throughput), so on revival
        ``get_decayed`` shrinks the old numbers toward the surviving
        lanes' mean and the rejoin traffic re-measures from scratch.
        Entries also drop ``in_process`` so the executor re-warms —
        same contract as a disk-loaded entry."""
        with self._lock:
            self._load_disk()
            for k, e in self._store.items():
                if k[1] != group:
                    continue
                e.t_obs = 0.0 if age_s is None else e.t_obs - age_s
                e.in_process = False
                self._dirty = True

    def sticky_plan(self, workload: str, total_units: int,
                    chunk_units: int, assigned: Sequence[int]
                    ) -> List[int]:
        """Damp plan drift: if the new chunk-rounded assignment moved by
        at most one chunk per group since the last call, keep the old
        assignment.  Chunk->group stability keeps data-dependent
        packings valid; a real drift (straggler) still replans, and
        work stealing absorbs the residual imbalance within the call."""
        assigned = [int(a) for a in assigned]
        with self._lock:
            prev = self._plans.get(workload)
            if (prev is not None and prev[0] == total_units
                    and prev[1] == chunk_units
                    and len(prev[2]) == len(assigned)
                    and all(abs(a - b) <= chunk_units
                            for a, b in zip(assigned, prev[2]))):
                return list(prev[2])
            self._plans[workload] = (total_units, chunk_units, assigned)
            return assigned

    def clear(self) -> None:
        """Forget everything, memory AND the persisted unit times for
        every backend (the ``hardware`` profile section is untouched —
        clearing calibration must not force a profile re-measure)."""
        with self._lock:
            self._store.clear()
            self._plans.clear()
            self._disk_loaded = True
            self._dirty = False
            self._disk.clear(_CALIB_SECTION)


_GLOBAL_CACHES: Dict[str, CalibrationCache] = {}
_GLOBAL_CACHE_PATH: Optional[str] = "unset"
_GLOBAL_LOCK = threading.Lock()


def get_calibration_cache(backend: str = "torch:cpu") -> CalibrationCache:
    """Process-wide cache per backend; re-resolved when
    REPRO_CALIB_CACHE changes (tests point it at tmp dirs)."""
    global _GLOBAL_CACHE_PATH
    path = default_calib_path()
    with _GLOBAL_LOCK:
        if _GLOBAL_CACHE_PATH != path:
            _GLOBAL_CACHES.clear()
            _GLOBAL_CACHE_PATH = path
        cache = _GLOBAL_CACHES.get(backend)
        if cache is None:
            cache = _GLOBAL_CACHES[backend] = CalibrationCache(
                path=path, backend=backend)
        return cache


def clear_calibration_cache(backend: str = "torch:cpu") -> None:
    get_calibration_cache(backend).clear()


def _flush_global_at_exit() -> None:
    """One module-level hook (not one per instance — tests repoint the
    store path and would otherwise pin every replaced instance alive
    and replay its stale deferred writes at exit): only the CURRENT
    global caches flush their deferred updates."""
    with _GLOBAL_LOCK:
        caches = list(_GLOBAL_CACHES.values())
    for cache in caches:
        cache.flush()


atexit.register(_flush_global_at_exit)
