"""The port's fault-tolerant serving (``repro_torch.ft``, the scheduler's
watchdog, retries, hedging and brownout) and its observability
(``PlacementAudit``, ``ServeStats``, the scheduler's trace spans),
mirroring ``tests/test_fault_tolerance.py`` and ``tests/test_obs.py``.

Scheduler tests drive toy spec factories against device-less accel/host
groups (real overlap: each lane its own thread), with calibration
pre-seeded so watchdog deadlines derive from small projected spans;
watchdog floors and hedge delays are sub-second, set through the
constructor.  The chaos injector is tested as pure data with a fake
clock.  The reference's engine tests (a dead lane during engine
routing, the engine's boundary cancellation) wait for the continuous
engine (ROADMAP queue 1, item 5).
"""
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

import pytest

from repro_torch.core.calibration import (CalibrationCache,
                                          clear_calibration_cache,
                                          get_calibration_cache)
from repro_torch.core.hybrid_executor import DeviceGroup, HybridExecutor
from repro_torch.core.metrics import Percentile, ServeStats
from repro_torch.ft.failure import (ChaosInjector, FailureInjector,
                                    HeartbeatMonitor, LaneFailure,
                                    LaneFault, ProcFault)
from repro_torch.obs import PlacementAudit, get_recorder
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.request_queue import (Request, RequestQueue,
                                             RequestRejected)
from repro_torch.serve.scheduler import Scheduler

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class ToySpec:
    workload: str
    total_units: int
    run_one: object
    run_share: object
    combine: object
    unit_cost: object = None
    comm_cost: float = 0.0
    whole_shares: bool = False
    bucket: str = "b"


def toy_factory(work_s: float = 0.0, units: int = 4):
    def factory(workload, payload):
        def run_one():
            if work_s:
                time.sleep(work_s)
            return ("done", workload, payload)

        def run_share(g, s, k):
            if work_s:
                time.sleep(work_s * k / units)
            return list(range(s, s + k))

        return ToySpec(workload=workload, total_units=units,
                       run_one=run_one, run_share=run_share,
                       combine=lambda outs: [x for o in outs for x in o],
                       bucket=f"{workload}/b")

    return factory


def raising_factory(run_one):
    def factory(workload, payload):
        return ToySpec(workload=workload, total_units=2, run_one=run_one,
                       run_share=run_one, combine=lambda o: o, bucket="b")
    return factory


def make_scheduler(**kw):
    groups = [DeviceGroup("accel", [], "accel"),
              DeviceGroup("host", [], "host")]
    kw.setdefault("executor", HybridExecutor(groups=groups, n_chunks=4))
    kw.setdefault("batch_window_s", 0.0)
    kw.setdefault("shared_span_factor", 1.0)
    return Scheduler(**kw)


def seed_affinity(s, workload="wl", accel=1e-3, host=2e-3):
    """Pre-seed calibration so placement projects small spans (the
    watchdog deadline is ``max(k * est_span, exec_timeout_s)``) and no
    probe/warmup re-runs the toy callables."""
    s._ex.cache.put(workload, "accel", accel)
    s._ex.cache.put(workload, "host", host)


@pytest.fixture(autouse=True)
def _fresh_state():
    clear_calibration_cache()
    yield
    sched_mod.shutdown_all(timeout=10.0)
    clear_calibration_cache()


def _wait(cond, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _invariant(st):
    return st.submitted == (st.completed + st.failed + st.rejected_full
                            + st.rejected_shutdown + st.rejected_failure
                            + st.shed_deadline + st.shed_brownout
                            + st.in_flight)


# ---------------------------------------------------------------------------
# watchdog timeout -> failover -> retry -> suspect rejoin
# ---------------------------------------------------------------------------
def test_watchdog_failover_retries_on_survivor_then_rejoins():
    inj = ChaosInjector([LaneFault(t=0.0, lane="accel", kind="hang",
                                   duration_s=0.6)])
    s = make_scheduler(spec_factory=toy_factory(work_s=0.005),
                       failure_injector=inj, max_batch=1,
                       split_overhead_s=100.0,
                       exec_timeout_s=0.08, exec_timeout_k=1.0,
                       watchdog_interval_s=0.01)
    s.start()
    seed_affinity(s)                       # accel faster -> hang lands there
    fut = s.submit("wl", {"i": 0})
    assert fut.result(timeout=10) == ("done", "wl", {"i": 0})
    st = s.stats
    assert st.watchdog_timeouts >= 1
    assert st.lane_deaths >= 1
    assert st.retries >= 1
    assert st.completed == 1               # exactly once, despite the
    #                                        late duplicate resolve
    assert _wait(lambda: s._loads["accel"].alive and
                 s.stats.lane_revivals >= 1)
    s.shutdown()
    assert st.completed == 1 and st.in_flight == 0 and _invariant(st)


def test_retry_budget_exhausted_is_structured_lane_failure():
    def run_one():
        raise LaneFailure("injected: lane wedged")

    s = make_scheduler(spec_factory=raising_factory(run_one), max_retries=1,
                       max_batch=1, split_overhead_s=100.0)
    s.start()
    seed_affinity(s)
    fut = s.submit("wl", None)
    with pytest.raises(RequestRejected) as ei:
        fut.result(timeout=10)
    assert ei.value.rejection.reason == "lane_failure"
    assert "retry budget" in ei.value.rejection.detail
    st = s.stats
    assert st.retries == 1                 # budget spent before rejecting
    assert st.rejected_failure == 1
    assert st.failed == 0 and st.completed == 0
    s.shutdown()
    assert st.in_flight == 0 and _invariant(st)


def test_lane_failure_exception_retried_to_success():
    attempts = []

    def run_one():
        attempts.append(1)
        if len(attempts) == 1:
            raise LaneFailure("transient blip")
        return ("ok", "wl")

    s = make_scheduler(spec_factory=raising_factory(run_one), max_batch=1,
                       split_overhead_s=100.0)
    s.start()
    seed_affinity(s)
    assert s.submit("wl", None).result(timeout=10) == ("ok", "wl")
    st = s.stats
    assert st.completed == 1
    assert st.retries >= 1
    assert st.failed == 0                  # lane faults never count as
    s.shutdown()                           # application failures
    assert st.in_flight == 0


def test_application_error_fails_future_without_burning_retries():
    def run_one():
        raise ValueError("bad payload")

    s = make_scheduler(spec_factory=raising_factory(run_one), max_batch=1,
                       split_overhead_s=100.0)
    s.start()
    seed_affinity(s)
    with pytest.raises(ValueError):
        s.submit("wl", None).result(timeout=10)
    st = s.stats
    assert st.failed == 1
    assert st.retries == 0 and st.rejected_failure == 0
    s.shutdown()
    assert st.in_flight == 0


# ---------------------------------------------------------------------------
# hedged requests, first result wins
# ---------------------------------------------------------------------------
def test_hedge_duplicates_slow_request_first_result_wins():
    inj = ChaosInjector([LaneFault(t=0.0, lane="accel", kind="hang",
                                   duration_s=0.5)])
    s = make_scheduler(spec_factory=toy_factory(work_s=0.005),
                       failure_injector=inj, max_batch=1,
                       split_overhead_s=100.0,
                       hedge_delay_s=0.02, watchdog_interval_s=0.005)
    s.start()
    seed_affinity(s)                       # original lands on accel
    fut = s.submit("wl", {"i": 0}, hedge=True)
    assert fut.result(timeout=10) == ("done", "wl", {"i": 0})
    st = s.stats
    assert st.hedges == 1
    assert st.hedge_wins == 1
    assert st.completed == 1
    assert fut.meta["lane"] == "host"      # the duplicate's stamp
    s.shutdown()                           # joins the hung original
    assert st.completed == 1 and st.in_flight == 0


# ---------------------------------------------------------------------------
# brownout degradation while a lane is down
# ---------------------------------------------------------------------------
def test_brownout_sheds_best_effort_keeps_normal_traffic():
    inj = FailureInjector(kill={1: "accel"})
    s = make_scheduler(spec_factory=toy_factory(work_s=0.005),
                       failure_injector=inj, max_batch=1,
                       split_overhead_s=100.0)
    assert s.submit("wl", {"i": 0}).result(timeout=10)[0] == "done"
    assert s.submit("wl", {"i": 1}).result(timeout=10)[0] == "done"
    assert not s._loads["accel"].alive     # step-1 kill landed
    fut_be = s.submit("wl", {"i": 2}, priority=-1)
    with pytest.raises(RequestRejected) as ei:
        fut_be.result(timeout=1)
    assert ei.value.rejection.reason == "brownout"
    assert s.stats.shed_brownout == 1
    assert s.submit("wl", {"i": 3}).result(timeout=10) \
        == ("done", "wl", {"i": 3})
    st = s.stats
    s.shutdown()
    assert st.completed == 3 and st.in_flight == 0 and _invariant(st)


def test_monolithic_all_lanes_dead_counts_as_rejected():
    groups = [DeviceGroup("accel", [], "accel")]
    s = Scheduler(executor=HybridExecutor(groups=groups, n_chunks=2),
                  spec_factory=toy_factory(work_s=0.0), batch_window_s=0.0,
                  max_batch=1, shared_span_factor=1.0,
                  failure_injector=FailureInjector(kill={0: "accel"}))
    fut = s.submit("wl", {"i": 0})
    with pytest.raises(RequestRejected) as ei:
        fut.result(timeout=10)
    assert ei.value.rejection.reason == "lane_failure"
    assert "no alive device group" in ei.value.rejection.detail
    st = s.stats
    assert st.rejected_failure == 1 and st.failed == 0
    s.shutdown()
    assert st.in_flight == 0


def test_kill_during_shared_execution_keeps_exactly_once():
    inj = FailureInjector(kill={2: "accel"})
    s = make_scheduler(spec_factory=toy_factory(work_s=0.05),
                       failure_injector=inj, max_batch=1,
                       split_overhead_s=0.0)
    futs = [s.submit("wl", i) for i in range(5)]
    vals = [f.result(timeout=30) for f in futs]
    st = s.stats
    s.shutdown()
    assert len(vals) == 5
    assert st.completed == 5
    assert st.shared >= 1                  # a split actually ran
    assert st.lane_deaths == 1
    assert st.failed == 0 and st.in_flight == 0


def test_chaos_kill_then_revive_through_the_scheduler():
    """A time-based kill lands at a dispatch, later requests go to the
    survivor, the scripted revive brings the lane back."""
    t = {"now": 0.0}
    inj = ChaosInjector([LaneFault(t=1.0, lane="accel", kind="kill"),
                         LaneFault(t=2.0, lane="accel", kind="revive")],
                        clock=lambda: t["now"])
    inj.arm()
    s = make_scheduler(spec_factory=toy_factory(work_s=0.002),
                       failure_injector=inj, max_batch=1,
                       split_overhead_s=100.0, watchdog_interval_s=0.01)
    s.start()
    seed_affinity(s)
    assert s.submit("wl", 0).result(timeout=10)[0] == "done"
    t["now"] = 1.5
    assert s.submit("wl", 1).result(timeout=10)[0] == "done"
    assert not s._loads["accel"].alive
    t["now"] = 2.5
    assert _wait(lambda: s._loads["accel"].alive)
    st = s.stats
    s.shutdown()
    assert st.lane_deaths == 1 and st.lane_revivals == 1
    assert st.completed == 2 and _invariant(st)


# ---------------------------------------------------------------------------
# chaos injector and heartbeats: pure data with a fake clock
# ---------------------------------------------------------------------------
def test_lane_fault_validates_kind():
    with pytest.raises(ValueError):
        LaneFault(t=0.0, lane="a", kind="explode")


def test_chaos_at_time_emits_each_transition_exactly_once():
    t = {"now": 100.0}
    inj = ChaosInjector([LaneFault(t=1.0, lane="a", kind="kill"),
                         LaneFault(t=2.0, lane="a", kind="revive")],
                        clock=lambda: t["now"])
    inj.arm()
    assert inj.at_time() == ([], [])
    t["now"] = 101.5
    assert inj.at_time() == (["a"], [])
    assert inj.at_time() == ([], [])       # once, not re-emitted
    t["now"] = 102.5
    assert inj.at_time() == ([], ["a"])
    assert inj.at_time() == ([], [])
    assert not hasattr(inj, "at_step")


def test_proc_fault_validates_kind_and_emits_exactly_once():
    with pytest.raises(ValueError):
        ProcFault(t=0.0, worker="w0", kind="explode")
    t = {"now": 100.0}
    inj = ChaosInjector([
        ProcFault(t=1.0, worker="w0", kind="kill9"),
        LaneFault(t=1.5, lane="a", kind="kill"),
        ProcFault(t=2.0, worker="w0", kind="restart"),
    ], clock=lambda: t["now"])
    inj.arm()
    assert inj.at_time_proc() == []
    t["now"] = 101.2
    assert [f.kind for f in inj.at_time_proc()] == ["kill9"]
    assert inj.at_time_proc() == []
    t["now"] = 102.5
    assert inj.at_time() == (["a"], [])
    assert [f.kind for f in inj.at_time_proc()] == ["restart"]
    assert inj.at_time_proc() == []


def test_chaos_from_spec_builds_both_kinds_and_rejects_typos():
    inj = ChaosInjector.from_spec([
        {"t": 0.5, "lane": "a", "kind": "slow", "duration_s": 1.0,
         "factor": 2.0},
        {"t": 1.0, "worker": "w0", "kind": "stall", "duration_s": 0.2}])
    assert [f.kind for f in inj.faults] == ["slow"]
    assert [f.kind for f in inj.proc_faults] == ["stall"]
    with pytest.raises(ValueError):
        ChaosInjector.from_spec([{"t": 0.0, "kind": "kill"}])
    with pytest.raises(ValueError):
        ChaosInjector.from_spec([{"t": 0.0, "lane": "a", "kind": "kil"}])


def test_chaos_exec_fault_kill_until_revive_and_windows():
    t = {"now": 0.0}
    inj = ChaosInjector([
        LaneFault(t=1.0, lane="a", kind="kill"),
        LaneFault(t=2.0, lane="a", kind="revive"),
        LaneFault(t=3.0, lane="a", kind="hang", duration_s=0.5),
        LaneFault(t=5.0, lane="b", kind="slow", duration_s=1.0,
                  factor=3.0),
    ], clock=lambda: t["now"])
    inj.arm()
    assert inj.exec_fault("a") is None
    t["now"] = 1.5
    f = inj.exec_fault("a")
    assert f is not None and f.kind == "kill"
    assert inj.exec_fault("b") is None
    t["now"] = 2.5
    assert inj.exec_fault("a") is None
    t["now"] = 3.2
    f = inj.exec_fault("a")
    assert f.kind == "hang" and f.duration_s == 0.5
    t["now"] = 3.8
    assert inj.exec_fault("a") is None
    t["now"] = 5.5
    f = inj.exec_fault("b")
    assert f.kind == "slow" and f.factor == 3.0


def test_chaos_flaky_draws_are_seed_deterministic():
    faults = [LaneFault(t=0.0, lane="a", kind="flaky", duration_s=10.0,
                        p=0.5)]
    t = {"now": 1.0}
    a = ChaosInjector(faults, clock=lambda: t["now"], seed=7)
    b = ChaosInjector(faults, clock=lambda: t["now"], seed=7)
    a.arm(t0=0.0)
    b.arm(t0=0.0)
    seq_a = [a.exec_fault("a") is not None for _ in range(64)]
    seq_b = [b.exec_fault("a") is not None for _ in range(64)]
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)


def test_failure_injector_and_heartbeat_monitor():
    inj = FailureInjector(kill={3: "accel"}, revive={5: "accel"})
    assert inj.at_step(3) == ("accel", None)
    assert inj.at_step(5) == (None, "accel")
    assert inj.at_step(4) == (None, None)
    t = {"now": 0.0}
    hb = HeartbeatMonitor(["a", "b"], timeout_s=1.0, clock=lambda: t["now"])
    t["now"] = 0.5
    hb.beat("a")
    t["now"] = 1.2
    assert hb.check() == {"b"}
    hb.beat("b")
    assert hb.check() == set()


@pytest.mark.parametrize("name", ["LaneFailure", "HeartbeatMonitor",
                                  "FailureInjector", "ProcFault",
                                  "LaneFault", "ChaosInjector"])
def test_failure_module_matches_the_reference(name):
    """``ft/failure.py`` is the reference's, copied: the same names with
    the same fields and methods."""
    import dataclasses

    from repro.ft import failure as ref
    from repro_torch.ft import failure as mine

    a, b = getattr(mine, name), getattr(ref, name)
    if dataclasses.is_dataclass(b):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
    public = sorted(m for m in vars(b) if not m.startswith("__"))
    assert sorted(m for m in vars(a) if not m.startswith("__")) == public


# ---------------------------------------------------------------------------
# requeue path / percentile / calibration staleness primitives
# ---------------------------------------------------------------------------
def test_push_requeue_bypasses_closed_but_not_depth():
    q = RequestQueue(max_depth=1)
    q.close()
    rejected = q.push(Request(workload="w", payload=0))
    assert rejected is not None and rejected.reason == "shutdown"
    assert q.push(Request(workload="w", payload=1), requeue=True) is None
    full = q.push(Request(workload="w", payload=2), requeue=True)
    assert full is not None and full.reason == "queue_full"


def test_percentile_ring_buffer_quantiles():
    p = Percentile(maxlen=8)
    assert p.quantile(0.99) is None and p.n == 0
    for v in range(1, 11):                 # 1..10; window keeps 3..10
        p.observe(float(v))
    assert p.n == 8
    assert p.quantile(0.0) == 3.0
    assert p.quantile(1.0) == 10.0
    assert p.quantile(0.5) == 6.0


def test_percentile_window_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_PCTL_WINDOW", "32")
    p = Percentile()
    for i in range(100):
        p.observe(float(i))
    assert p.n == 32
    assert p.quantile(0.0) == 68.0
    assert Percentile(maxlen=8)._buf.maxlen == 8
    monkeypatch.setenv("REPRO_SERVE_PCTL_WINDOW", "junk")
    assert Percentile()._buf.maxlen == 256


def test_serve_stats_inc_is_atomic_under_contention():
    st = ServeStats()

    def bump():
        for _ in range(2000):
            st.inc(submitted=1, completed=1)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    snap = st.snapshot()
    assert st.submitted == st.completed == 16_000
    assert snap["submitted"] == snap["completed"] == 16_000
    assert st.in_flight == 0


@pytest.mark.parametrize("cls", ["ServeStats", "FleetStats"])
def test_stats_blocks_match_the_reference(cls):
    """The counter blocks are the reference's: the same snapshot keys
    and the same row after the same increments."""
    from repro.core import metrics as ref
    from repro_torch.core import metrics as mine

    a, b = getattr(mine, cls)(), getattr(ref, cls)()
    for st in (a, b):
        st.inc(submitted=5, completed=2, failed=1)
    assert a.snapshot() == b.snapshot()
    assert a.row() == b.row()


def test_mark_group_stale_shrinks_to_surviving_peers():
    cache = get_calibration_cache()
    cache.put("wl", "accel", 1e-3)
    cache.put("wl", "host", 8e-3)
    fresh = cache.get_decayed("wl", "host", peers=[("accel", 1.0)],
                              tau_s=300.0)
    assert fresh == pytest.approx(8e-3, rel=0.01)
    cache.mark_group_stale("host")         # lane death
    stale = cache.get_decayed("wl", "host", peers=[("accel", 1.0)],
                              tau_s=300.0)
    assert stale == pytest.approx(1e-3, rel=0.05)
    other = cache.get_decayed("wl", "accel", peers=[("host", 1.0)],
                              tau_s=300.0)
    assert other == pytest.approx(1e-3, rel=0.01)
    assert not cache.warmed_in_process("wl", "host")


def test_mark_group_stale_persists_to_fresh_process(tmp_path):
    """A staleness mark survives the disk round-trip: a fresh process
    (which imports only the port) loading the store after a lane death
    sees the dead lane's estimates shrunk toward the survivors."""
    path = str(tmp_path / "calib.json")
    cache = CalibrationCache(path=path)
    cache.put("wl", "accel", 1e-3)
    cache.put("wl", "host", 8e-3)
    cache.mark_group_stale("host")
    cache.flush()
    t0 = time.time()
    child = (
        "import json\n"
        "from repro_torch.core.calibration import get_calibration_cache\n"
        "c = get_calibration_cache()\n"
        f"now = {t0!r}\n"
        "print('RESULT' + json.dumps({\n"
        "    'host': c.get_decayed('wl', 'host', now=now,\n"
        "                          peers=[('accel', 1.0)], tau_s=300.0),\n"
        "    'accel': c.get_decayed('wl', 'accel', now=now,\n"
        "                           peers=[('host', 1.0)], tau_s=300.0),\n"
        "    'warm': c.warmed_in_process('wl', 'host')}))\n")
    env = dict(os.environ, REPRO_CALIB_CACHE=path,
               PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", child], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    got = json.loads(line[len("RESULT"):])
    assert got["host"] == pytest.approx(1e-3, rel=0.05)
    assert got["accel"] == pytest.approx(1e-3, rel=0.01)
    assert got["warm"] is False


# ---------------------------------------------------------------------------
# observability: the placement audit and the scheduler's trace spans
# ---------------------------------------------------------------------------
def test_placement_audit_error_math_and_utilization():
    clock = {"t": 100.0}
    audit = PlacementAudit(clock=lambda: clock["t"])
    audit.record(1, "conv", "dedicated", projected_s=0.010,
                 alternatives={"shared": 0.02})
    audit.record(2, "conv", "dedicated", projected_s=0.020)
    audit.record(3, "hist", "shared", projected_s=0.005)
    audit.stamp(1, actual_s=0.012)     # abs err 2 ms, rel 1/6
    audit.stamp(2, actual_s=0.010)     # abs err 10 ms, rel 1.0
    audit.stamp(99, actual_s=1.0)      # never recorded: no-op
    audit.lane_busy("accel", 5.0)
    audit.lane_busy("accel", 1.0)
    audit.lane_busy("host", 3.0)
    clock["t"] = 110.0                 # 10 s window

    s = audit.summary()
    conv = s["placements"]["conv:dedicated"]
    assert conv["n"] == 2
    assert conv["mean_abs_err_s"] == pytest.approx((0.002 + 0.010) / 2)
    assert conv["mean_rel_err"] == pytest.approx(
        (0.002 / 0.012 + 0.010 / 0.010) / 2)
    assert conv["max_rel_err"] == pytest.approx(1.0)
    assert s["open_decisions"] == 1
    assert s["lane_utilization"] == pytest.approx(
        {"accel": 0.6, "host": 0.3})
    assert s["resource_efficiency"] == pytest.approx(0.45)
    assert s["window_s"] == pytest.approx(10.0)
    audit.stamp(1, actual_s=9.9)
    assert audit.summary()["placements"]["conv:dedicated"]["n"] == 2
    audit.reset()
    assert audit.summary()["placements"] == {}


def test_scheduler_audits_every_placement():
    s = make_scheduler(spec_factory=toy_factory(work_s=0.002),
                       max_batch=1, split_overhead_s=100.0)
    for f in [s.submit("wl", i) for i in range(6)]:
        f.result(timeout=10)
    s.shutdown()
    summ = s.audit.summary()
    assert sum(v["n"] for v in summ["placements"].values()) == 6
    assert summ["open_decisions"] == 0
    assert set(summ["lane_utilization"]) <= {"accel", "host"}


@pytest.fixture
def live_recorder():
    rec = get_recorder()
    was = rec.enabled
    rec.enabled = True
    rec.clear()
    yield rec
    rec.enabled = was
    rec.clear()


def test_scheduler_spans_share_one_trace_id(live_recorder):
    """One real request on the CPU pair leaves a stitched lifecycle:
    submit instant, queue_wait + placement + lane_exec spans and a
    resolve instant, all under the caller's trace_id."""
    sched = Scheduler(device="cpu", batch_window_s=0.0,
                      shared_span_factor=1.0, split_overhead_s=100.0)
    sched.submit("hist", {"n": 1 << 10, "n_bins": 16},
                 trace_id="tid-life").result(timeout=120)
    sched.shutdown()
    mine = [e for e in live_recorder.events()
            if e["args"].get("trace_id") == "tid-life"]
    names = {e["name"] for e in mine}
    assert {"submit", "queue_wait", "placement", "lane_exec",
            "resolve"} <= names
    for e in mine:
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
    lane_tracks = {e["track"] for e in mine if e["name"] == "lane_exec"}
    assert all(t.startswith("lane:") for t in lane_tracks)
