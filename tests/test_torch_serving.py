"""The port's serving core (``repro_torch.serve``,
``repro_torch.workloads.requests``) against the JAX reference's, on the
CPU.

Queue, placement and scheduler tests mirror ``tests/test_serving.py``:
toy spec factories (pure-Python work with deterministic sleeps) on
device-less groups, the placement policy as pure data with fake clocks.
The request adapters run on the CPU lane (``lane_device("cpu")``, the
simulated pair's device) and are held against the reference's adapters
on the same numpy payloads at the reference tests' tolerances
(ROADMAP "Parity rules"): hist, sort, listrank and dither exact; conv
2e-4; spmv, spgemm and raycast 1e-4 (raycast against the reference's
op-by-op march, whose compiled form contracts an FMA); lbm 1e-5;
bilateral 1e-3; attention 2e-5; montecarlo relative 1e-5; bundle
relative 1e-3; concomp the same partition.  Merged batches demux
bitwise equal to each member's solo ``run_one``.
"""
import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from repro_torch.core.calibration import (clear_calibration_cache,
                                          get_calibration_cache)
from repro_torch.core.hybrid_executor import DeviceGroup, HybridExecutor
from repro_torch.ft.failure import FailureInjector
from repro_torch.kernels.common import current_device, lane_device
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.placement import (DEDICATED, SHARED, GroupLoad,
                                         deadline_feasible, plan_placement)
from repro_torch.serve.request_queue import (Request, RequestQueue,
                                             RequestRejected, Rejection,
                                             ServeFuture)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.workloads import ALL_WORKLOADS
from repro_torch.workloads import requests as adapters

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# toy specs
# ---------------------------------------------------------------------------
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


def toy_factory(work_s: float = 0.0, units: int = 4, record=None):
    """Spec factory: run_one sleeps work_s and echoes the payload;
    run_share covers [start, start+k)."""

    def factory(workload, payload):
        def run_one():
            if work_s:
                time.sleep(work_s)
            if record is not None:
                record.append(payload)
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


def toy_groups():
    return [DeviceGroup("accel", [], "accel"),
            DeviceGroup("host", [], "host")]


def make_scheduler(**kw):
    kw.setdefault("executor", HybridExecutor(groups=toy_groups(),
                                             n_chunks=4))
    kw.setdefault("batch_window_s", 0.0)
    return Scheduler(**kw)


def cpu_scheduler(**kw):
    """The simulated pair on the CPU, the span factor pinned (no probe)."""
    kw.setdefault("shared_span_factor", 1.0)
    return Scheduler(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh_state():
    clear_calibration_cache()
    yield
    sched_mod.shutdown_all(timeout=10.0)
    clear_calibration_cache()


# ---------------------------------------------------------------------------
# request queue
# ---------------------------------------------------------------------------
def test_queue_bounded_rejects_with_structure():
    q = RequestQueue(max_depth=2)
    r1, r2, r3 = (Request(workload="w", payload=i) for i in range(3))
    assert q.push(r1) is None
    assert q.push(r2) is None
    rej = q.push(r3)
    assert rej is not None and rej.reason == "queue_full"
    with pytest.raises(RequestRejected) as ei:
        r3.future.result(timeout=1)
    assert ei.value.rejection.reason == "queue_full"
    assert ei.value.rejection.queue_depth == 2


def test_queue_priority_then_fifo():
    q = RequestQueue(max_depth=8)
    reqs = [Request(workload="w", payload=i, priority=p)
            for i, p in enumerate([0, 5, 0, 5])]
    for r in reqs:
        q.push(r)
    popped = [q.pop(timeout=0.1)[0].payload for _ in range(4)]
    assert popped == [1, 3, 0, 2]      # high priority first, FIFO within


def test_queue_sheds_expired_deadlines_on_pop():
    t = {"now": 100.0}
    q = RequestQueue(max_depth=8, clock=lambda: t["now"])
    dead = Request(workload="w", payload="late", deadline_s=0.5,
                   t_submit=100.0, t_deadline=100.5)
    live = Request(workload="w", payload="ok")
    q.push(dead)
    q.push(live)
    t["now"] = 101.0                   # deadline passed while queued
    got, shed = q.pop(timeout=0.1)
    assert [r.payload for r in shed] == ["late"]
    with pytest.raises(RequestRejected) as ei:
        dead.future.result(timeout=1)
    assert ei.value.rejection.reason == "deadline"
    if got is None:                    # shed-only pop; the live one next
        got, _ = q.pop(timeout=0.1)
    assert got.payload == "ok"


def test_future_resolves_exactly_once():
    f = ServeFuture()
    assert f._resolve(1) is True
    assert f._resolve(2) is False
    assert f._reject(RuntimeError("x")) is False
    assert f.result(timeout=1) == 1


def test_pop_matching_coalesces_same_bucket_only():
    q = RequestQueue(max_depth=8)
    a1 = Request(workload="a", payload=1, bucket="x")
    a2 = Request(workload="a", payload=2, bucket="x")
    b1 = Request(workload="b", payload=3, bucket="y")
    for r in (a1, a2, b1):
        q.push(r)
    got = q.pop_matching("a", "x", limit=8)
    assert sorted(r.payload for r in got) == [1, 2]
    assert len(q) == 1                 # b stays queued


def test_rejection_dataclass_fields():
    r = Rejection("deadline", "wl", detail="d", queue_depth=3,
                  deadline_s=0.5, waited_s=0.1)
    err = RequestRejected(r)
    assert "deadline" in str(err) and err.rejection is r


# ---------------------------------------------------------------------------
# placement policy (pure, fake clocks)
# ---------------------------------------------------------------------------
def test_placement_picks_fastest_free_group():
    loads = [GroupLoad("accel", unit_time=0.001, busy_until=0.0),
             GroupLoad("host", unit_time=0.004, busy_until=0.0)]
    d = plan_placement(10, loads, now=0.0, split_overhead_s=1.0)
    assert d.kind == DEDICATED and d.groups == ["accel"]
    assert d.t_finish == pytest.approx(0.01)


def test_placement_prefers_split_when_win_exceeds_overhead():
    loads = [GroupLoad("accel", unit_time=0.001, busy_until=0.0),
             GroupLoad("host", unit_time=0.001, busy_until=0.0)]
    d = plan_placement(100, loads, now=0.0, split_overhead_s=0.001)
    assert d.kind == SHARED
    assert d.t_finish < 0.1            # dedicated would take 0.1
    d2 = plan_placement(100, loads, now=0.0, split_overhead_s=0.06)
    assert d2.kind == DEDICATED


def test_placement_routes_around_backlog():
    loads = [GroupLoad("accel", unit_time=0.001, busy_until=10.0),
             GroupLoad("host", unit_time=0.002, busy_until=0.0)]
    d = plan_placement(10, loads, now=0.0, split_overhead_s=100.0)
    assert d.groups == ["host"]
    assert not d.queued
    loads = [GroupLoad("accel", unit_time=0.001, busy_until=1.0),
             GroupLoad("host", unit_time=0.002, busy_until=5.0)]
    d = plan_placement(10, loads, now=0.0, split_overhead_s=100.0)
    assert d.groups == ["accel"] and d.queued
    assert d.queued_behind_s == pytest.approx(1.0)


def test_placement_skips_dead_groups_and_deadline_check():
    loads = [GroupLoad("accel", unit_time=0.001, alive=False),
             GroupLoad("host", unit_time=0.004)]
    d = plan_placement(10, loads, now=0.0)
    assert d.groups == ["host"]
    assert deadline_feasible(d, now=0.0, t_deadline=1.0)
    assert not deadline_feasible(d, now=0.0, t_deadline=0.01)
    assert plan_placement(10, [GroupLoad("a", 1.0, alive=False)], 0.0) \
        is None


@pytest.mark.parametrize("others_busy, est, finish", [
    (1.0, 0.2, 0.2),          # the whole span overlaps b's busy window
    (0.05, None, 0.125),      # 0.05 s at half rate, the rest at full
    (0.0, 0.1, 0.1),          # a free host pays no contention
])
def test_dedicated_contention_projection(others_busy, est, finish):
    loads = [GroupLoad("a", unit_time=0.001, busy_until=0.0),
             GroupLoad("b", unit_time=0.001, busy_until=others_busy)]
    d = plan_placement(100, loads, now=0.0, split_overhead_s=100.0,
                       contention_factor=2.0)
    assert d.groups == ["a"]
    assert d.t_finish == pytest.approx(finish)
    if est is not None:
        assert d.est_exec_s == pytest.approx(est)
    # the default factor 1.0 keeps the uncontended projection
    d1 = plan_placement(100, loads, now=0.0, split_overhead_s=100.0)
    assert d1.est_exec_s == pytest.approx(0.1)


def test_placement_functions_match_the_reference():
    """The pure policy is copied from the reference: the same decisions
    on random loads."""
    from repro.serve import placement as ref_pl

    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 300))
        raw = [(float(rng.uniform(1e-4, 1e-2)), float(rng.uniform(0, 1)),
                bool(rng.random() < 0.9)) for _ in range(2)]
        kw = dict(split_overhead_s=float(rng.uniform(0, 0.05)),
                  shared_span_factor=float(rng.uniform(1, 2)),
                  contention_factor=float(rng.uniform(1, 2)))
        mine = plan_placement(n, [GroupLoad(g, u, b, a) for g, (u, b, a)
                                  in zip("ab", raw)], 0.5, **kw)
        ref = ref_pl.plan_placement(
            n, [ref_pl.GroupLoad(g, u, b, a) for g, (u, b, a)
                in zip("ab", raw)], 0.5, **kw)
        if ref is None:
            assert mine is None
            continue
        assert (mine.kind, mine.groups) == (ref.kind, ref.groups)
        assert mine.t_finish == ref.t_finish
        assert mine.alternatives == ref.alternatives


# ---------------------------------------------------------------------------
# scheduler: concurrency, demux, lifecycle
# ---------------------------------------------------------------------------
def test_concurrent_submit_demux_integrity():
    """N threads submit interleaved requests; every future must get
    exactly its own payload back."""
    s = make_scheduler(spec_factory=toy_factory(work_s=0.001),
                       max_batch=4, batch_window_s=0.002,
                       split_overhead_s=100.0)
    results, errors = {}, []

    def client(tid):
        futs = [(i, s.submit(f"wl{tid % 3}", (tid, i)))
                for i in range(8)]
        for i, f in futs:
            try:
                results[(tid, i)] = f.result(timeout=30)
            except Exception as e:     # noqa: BLE001
                errors.append((tid, i, e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    s.shutdown()
    assert not errors
    assert len(results) == 48
    for (tid, i), val in results.items():
        assert val[0] == "done" and val[2] == (tid, i)
    assert s.stats.completed == 48 and s.stats.in_flight == 0


def test_deadline_shedding_returns_structured_rejection_not_hang():
    s = make_scheduler(spec_factory=toy_factory(work_s=0.2, units=4))
    blockers = [s.submit("slow", i) for i in range(6)]
    t0 = time.monotonic()
    f = s.submit("slow", "urgent", deadline=0.001)
    with pytest.raises(RequestRejected) as ei:
        f.result(timeout=5)
    waited = time.monotonic() - t0
    assert ei.value.rejection.reason == "deadline"
    assert ei.value.rejection.deadline_s == pytest.approx(0.001)
    assert waited < 2.0, "rejection must not wait for the backlog"
    for b in blockers:
        b.result(timeout=30)
    s.shutdown()
    assert s.stats.shed_deadline >= 1


def test_drain_resolves_every_inflight_future_exactly_once():
    s = make_scheduler(spec_factory=toy_factory(work_s=0.01),
                       max_batch=2, batch_window_s=0.001)
    resolutions, futs = [], []
    for i in range(12):
        f = s.submit("wl", i)
        f.add_done_callback(lambda fut: resolutions.append(fut))
        futs.append(f)
    assert s.drain(timeout=30)
    assert all(f.done() for f in futs)
    assert len(resolutions) == 12
    assert len(set(map(id, resolutions))) == 12
    late = s.submit("wl", "late")
    with pytest.raises(RequestRejected) as ei:
        late.result(timeout=1)
    assert ei.value.rejection.reason == "shutdown"
    s.shutdown()
    st = s.stats
    assert st.in_flight == 0
    assert st.submitted == (st.completed + st.failed + st.rejected_full
                            + st.rejected_shutdown + st.rejected_failure
                            + st.shed_deadline + st.shed_brownout)


def test_batching_coalesces_and_demuxes():
    record = []
    s = make_scheduler(spec_factory=toy_factory(work_s=0.002,
                                                record=record),
                       max_batch=8, batch_window_s=0.02,
                       split_overhead_s=100.0)
    futs = [s.submit("wl", i) for i in range(8)]
    vals = [f.result(timeout=30) for f in futs]
    s.shutdown()
    assert [v[2] for v in vals] == list(range(8))
    assert s.stats.batches >= 1, "same-bucket burst must coalesce"
    assert s.stats.batched_requests >= 2
    assert sorted(record) == list(range(8)), "each member runs once"


def test_queue_full_backpressure():
    s = make_scheduler(spec_factory=toy_factory(work_s=0.05), max_queue=2)
    futs = [s.submit("wl", i) for i in range(12)]
    rejected = 0
    for f in futs:
        try:
            f.result(timeout=30)
        except RequestRejected as e:
            assert e.rejection.reason == "queue_full"
            rejected += 1
    s.shutdown()
    assert rejected >= 1
    assert s.stats.rejected_full == rejected
    assert s.stats.completed == 12 - rejected


def test_failure_injection_kills_and_revives_group():
    inj = FailureInjector(kill={2: "accel"}, revive={6: "accel"})
    s = make_scheduler(spec_factory=toy_factory(work_s=0.005),
                       failure_injector=inj, max_batch=1,
                       split_overhead_s=100.0)
    futs = [s.submit("wl", i) for i in range(10)]
    vals = [f.result(timeout=30) for f in futs]
    s.shutdown()
    assert [v[2] for v in vals] == list(range(10))
    assert s.stats.completed == 10
    assert s.stats.lane_deaths == 1 and s.stats.lane_revivals == 1
    assert s.stats.dedicated + s.stats.shared >= 1


def test_scheduler_context_manager_and_stats_snapshot():
    with make_scheduler(spec_factory=toy_factory(),
                        split_overhead_s=100.0) as s:
        assert s.submit("wl", 0).result(timeout=10)[0] == "done"
        snap = s.stats.snapshot()
        assert snap["submitted"] == 1
    late = s.submit("wl", 1)
    with pytest.raises(RequestRejected):
        late.result(timeout=1)


def test_scheduler_executes_through_shared_hybrid_executor():
    s = make_scheduler(spec_factory=toy_factory(work_s=0.02, units=16),
                       max_batch=1, split_overhead_s=0.0)
    outs = [s.submit("big", i).result(timeout=30) for i in range(3)]
    s.shutdown()
    for o in outs:
        assert o == list(range(16)) or o[0] == "done"
    assert s.stats.completed == 3


def test_unknown_workload_fails_future_not_scheduler():
    s = Scheduler(groups=toy_groups(), shared_span_factor=1.0)
    f = s.submit("definitely-not-registered", {})
    with pytest.raises(KeyError):
        f.result(timeout=5)
    f2 = s.submit("definitely-not-registered", {})
    with pytest.raises(KeyError):
        f2.result(timeout=5)
    s.shutdown()
    assert s.stats.failed == 2


def test_exploration_heals_poisoned_estimate():
    """A stale-slow cached estimate must not starve a lane forever:
    exploration periodically routes one request there, and the fresh
    in-process measurement REPLACES the disk-poisoned value."""
    cache = get_calibration_cache()
    cache.put("wl", "accel", 1.0)
    cache._store[cache.key("wl", "accel")].in_process = False
    cache.put("wl", "host", 1e-4)
    s = make_scheduler(spec_factory=toy_factory(work_s=0.001, units=4),
                       max_batch=1, split_overhead_s=100.0,
                       explore_every=4)
    for f in [s.submit("wl", i) for i in range(16)]:
        f.result(timeout=30)
    s.shutdown()
    healed = cache.get("wl", "accel")
    assert healed is not None and healed < 0.1


def test_get_decayed_shrinks_stale_entry_toward_peers():
    cache = get_calibration_cache()
    cache.put("wl", "accel", 1.0)
    cache.put("wl", "host", 1e-3)
    peers = [("host", 1.0)]
    assert cache.get_decayed("wl", "accel", peers=peers, tau_s=60.0) \
        == pytest.approx(1.0, rel=0.01)
    cache._store[cache.key("wl", "accel")].t_obs = time.time() - 1e6
    v = cache.get_decayed("wl", "accel", peers=peers, tau_s=60.0)
    assert v == pytest.approx(1e-3, rel=0.01)
    assert cache.get_decayed("wl", "accel", peers=peers, tau_s=0.0) \
        == pytest.approx(1.0)
    assert cache.get_decayed("nope", "accel", peers=peers,
                             tau_s=60.0) is None


def test_staleness_decay_heals_lane_without_exploration():
    cache = get_calibration_cache()
    cache.put("wl", "accel", 1.0)
    cache._store[cache.key("wl", "accel")].t_obs = time.time() - 1e6
    cache._store[cache.key("wl", "accel")].in_process = False
    cache.put("wl", "host", 1e-3)
    s = make_scheduler(spec_factory=toy_factory(work_s=0.001, units=4),
                       max_batch=1, split_overhead_s=100.0,
                       explore_every=0, staleness_tau_s=60.0)
    for f in [s.submit("wl", i) for i in range(16)]:
        f.result(timeout=30)
    s.shutdown()
    healed = cache.get("wl", "accel")
    assert healed is not None and healed < 0.1


def test_span_factor_self_probe_bounds_and_pin(monkeypatch):
    monkeypatch.delenv("REPRO_SERVE_SPAN_FACTOR", raising=False)
    monkeypatch.delenv("REPRO_SERVE_SPAN_FACTOR_HOST", raising=False)
    sched_mod._SPAN_FACTOR_CACHE.clear()
    s = make_scheduler(spec_factory=toy_factory())
    try:
        assert 1.0 <= s.shared_span_factor <= 2.0
        assert set(s.span_factors) == {"torch", "host"}
        assert all(1.0 <= v <= 2.0 for v in s.span_factors.values())
        assert sched_mod._SPAN_FACTOR_CACHE, "probe result not memoized"
    finally:
        s.shutdown()
    before = dict(sched_mod._SPAN_FACTOR_CACHE)
    s2 = make_scheduler(spec_factory=toy_factory())
    try:
        assert dict(sched_mod._SPAN_FACTOR_CACHE) == before
    finally:
        s2.shutdown()
    monkeypatch.setenv("REPRO_SERVE_SPAN_FACTOR", "1.37")
    monkeypatch.setenv("REPRO_SERVE_SPAN_FACTOR_HOST", "1.11")
    s3 = make_scheduler(spec_factory=toy_factory())
    try:
        assert s3.shared_span_factor == pytest.approx(1.37)
        assert s3.span_factors["host"] == pytest.approx(1.11)
    finally:
        s3.shutdown()
    monkeypatch.delenv("REPRO_SERVE_SPAN_FACTOR")
    s4 = make_scheduler(spec_factory=toy_factory(), policy="fifo")
    try:
        assert s4.shared_span_factor == 1.0
    finally:
        s4.shutdown()


def test_continuous_route_is_off_until_the_engine_is_ported(monkeypatch):
    """The engine is ported: its route is on by default and
    ``REPRO_SERVE_CONTINUOUS=0`` turns it off, as in the reference."""
    monkeypatch.delenv("REPRO_SERVE_CONTINUOUS", raising=False)
    assert sched_mod.continuous_enabled() is True
    monkeypatch.setenv("REPRO_SERVE_CONTINUOUS", "0")
    assert sched_mod.continuous_enabled() is False


# ---------------------------------------------------------------------------
# lane devices: a dedicated execution runs on its group's device
# ---------------------------------------------------------------------------
def test_dedicated_execution_runs_on_its_groups_device():
    """Each lane sets its group's device as the thread's lane device for
    the execution, and the result says where it ran.  The accel group
    here is the ``meta`` device (no GPU on this box), so the two lanes'
    devices differ."""
    seen = {}

    def factory(workload, payload):
        def run_one():
            seen[payload] = str(current_device())
            return payload
        return ToySpec(workload=workload, total_units=1, run_one=run_one,
                       run_share=lambda g, s, k: run_one(),
                       combine=lambda o: o[0], bucket=workload)

    groups = [DeviceGroup("accel", [torch.device("meta")], "accel"),
              DeviceGroup("host", [CPU], "host")]
    s = Scheduler(groups=groups, spec_factory=factory, max_batch=1,
                  batch_window_s=0.0, shared_span_factor=1.0,
                  explore_every=2)
    futs = [s.submit("wl", i) for i in range(8)]
    for f in futs:
        f.result(timeout=30)
    s.shutdown()
    lanes = {f.meta["lane"] for f in futs}
    assert lanes == {"accel", "host"}
    for i, f in enumerate(futs):
        want = "meta" if f.meta["lane"] == "accel" else "cpu"
        assert seen[i] == want == f.meta["device"]


def test_adapter_outside_a_lane_needs_a_gpu_or_an_explicit_device():
    """No silent fallback: with no lane device set, run_one resolves the
    first GPU, and raises without one."""
    spec = adapters.make_request("conv", {"size": 32, "ksize": 3})
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: run_one would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.run_one()
    with lane_device(CPU):
        assert spec.run_one().device == CPU


@pytest.mark.parametrize("wl", ["listrank", "lbm", "dither"])
def test_continuous_payload_raises_until_the_engine_is_ported(wl):
    """The engine is ported: a ``continuous=True`` payload carries the
    workload's stepper (one per shape, shared), a plain one none."""
    spec = adapters.make_request(wl, {"continuous": True})
    assert spec.stepper is not None
    assert adapters.make_request(wl, {"continuous": True}).stepper \
        is spec.stepper
    assert spec.stepper.workload == spec.workload
    assert adapters.make_request(wl, {}).stepper is None


# ---------------------------------------------------------------------------
# request adapters against the reference's, on the same numpy payloads
# ---------------------------------------------------------------------------
SMALL_PAYLOADS = {
    "conv": {"size": 64, "ksize": 5},
    "hist": {"n": 1 << 12, "n_bins": 64},
    "spmv": {"n": 128, "density": 0.05},
    "sort": {"n": 1 << 10},
    "spgemm": {"n": 96, "density": 0.05},
    "raycast": {"n_rays": 256, "d": 8},
    "bilateral": {"size": 48, "radius": 3},
    "montecarlo": {"n_photons": 1 << 10, "unit": 1 << 7},
    "listrank": {"n": 1 << 8},
    "concomp": {"n": 1 << 8},
    "lbm": {"d": 6, "n_steps": 2},
    "dither": {"h": 32, "w": 32},
    "bundle": {"n_cams": 2, "n_pts": 32},
}
TOL = {"conv": 2e-4, "spmv": 1e-4, "spgemm": 1e-4, "raycast": 1e-4,
       "lbm": 1e-5, "bilateral": 1e-3, "attention": 2e-5}
EXACT = ("hist", "sort", "listrank", "dither")


def _attention_payload(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, 32, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, batch, 32, 2, 16)).astype(np.float32)
    return {"q": q, "k": kv[0], "v": kv[1]}


PAYLOADS = dict(SMALL_PAYLOADS, attention=_attention_payload())


def _canonical(lab):
    first = {}
    return np.asarray([first.setdefault(int(x), len(first)) for x in lab])


def _ref_value(wl, payload):
    import jax

    from repro.workloads import requests as ref_adapters

    spec = ref_adapters.make_request(wl, payload)
    if wl == "raycast":
        # the reference's op-by-op march (its compiled form contracts
        # ``o + d * t`` into an FMA: ROADMAP queue 3)
        with jax.disable_jit():
            return np.asarray(spec.run_one())
    out = spec.run_one()
    return out if isinstance(out, float) else np.asarray(out)


def _np(value):
    if isinstance(value, float):
        return value
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _hold(wl, mine, ref):
    if wl == "concomp":
        np.testing.assert_array_equal(_canonical(mine), _canonical(ref))
    elif wl in EXACT:
        np.testing.assert_array_equal(mine, ref)
    elif wl == "montecarlo":
        assert mine == pytest.approx(ref, rel=1e-5)
    elif wl == "bundle":
        assert mine == pytest.approx(ref, rel=1e-3)
    else:
        np.testing.assert_allclose(mine, ref, rtol=TOL[wl], atol=TOL[wl])


@pytest.mark.parametrize("wl", sorted(PAYLOADS))
def test_adapter_run_one_matches_reference(wl):
    spec = adapters.make_request(wl, PAYLOADS[wl])
    with lane_device(CPU):
        mine = _np(spec.run_one())
    _hold(wl, mine, _ref_value(wl, PAYLOADS[wl]))
    from repro.workloads import requests as ref_adapters

    ref_spec = ref_adapters.make_request(wl, PAYLOADS[wl])
    assert (spec.workload, spec.total_units, spec.bucket) == \
        (ref_spec.workload, ref_spec.total_units, ref_spec.bucket)
    assert spec.whole_shares == ref_spec.whole_shares
    assert spec.lane_class == {"jax": "torch"}.get(ref_spec.lane_class,
                                                   ref_spec.lane_class)


SPLITTABLE = sorted(w for w in PAYLOADS
                    if w not in ("listrank", "lbm", "dither", "bundle"))


@pytest.mark.parametrize("wl", SPLITTABLE)
def test_adapter_shares_match_reference(wl):
    """run_share over two (and, for the halo workloads, three) shares,
    each on its group's lane, then combine: the reference's run_one."""
    spec = adapters.make_request(wl, PAYLOADS[wl])
    ref = _ref_value(wl, PAYLOADS[wl])
    n = spec.total_units
    splits = [[("accel", 0, n // 2), ("host", n // 2, n - n // 2)]]
    if wl in ("conv", "bilateral"):
        t = n // 3
        splits.append([("accel", 0, t), ("host", t, t),
                       ("accel", 2 * t, n - 2 * t)])
    for split in splits:
        with lane_device(CPU):
            parts = [spec.run_share(g, s, k) for g, s, k in split]
            _hold(wl, _np(spec.combine(parts)), ref)


def test_every_table1_workload_is_registered():
    from repro.workloads import requests as ref_adapters

    assert len(ALL_WORKLOADS) == 13
    assert set(ALL_WORKLOADS) <= set(adapters.available())
    assert adapters.available() == ref_adapters.available()


@pytest.mark.parametrize("wl", sorted(SMALL_PAYLOADS))
def test_cold_prior_covers_workload(wl):
    """Zero-probe cold placement: every Table-1 adapter ships a
    ``unit_cost`` prior the cost model prices for every group — the
    reference's terms."""
    from repro.workloads import requests as ref_adapters
    from repro_torch.core import cost_model

    spec = adapters.make_request(wl, SMALL_PAYLOADS[wl])
    uc = spec.unit_cost
    assert uc is not None, f"{wl} has no cost prior"
    ref_uc = ref_adapters.make_request(wl, SMALL_PAYLOADS[wl]).unit_cost
    terms = list(uc.values()) if isinstance(uc, dict) else [uc]
    ref_terms = (list(ref_uc.values()) if isinstance(ref_uc, dict)
                 else [ref_uc])
    for t, r in zip(terms, ref_terms):
        assert cost_model.predict(t, CPU) > 0
        assert (t.flops, t.bytes, t.steps) == pytest.approx(
            (r.flops, r.bytes, r.steps))


@pytest.mark.parametrize("wl", sorted(SMALL_PAYLOADS))
def test_cold_calibrate_plans_with_zero_probes(wl):
    """A cold cache + the adapter's prior plans the work share without
    executing a single probe (``last_probe_runs == 0``)."""
    spec = adapters.make_request(wl, SMALL_PAYLOADS[wl])
    ex = HybridExecutor(device="cpu", n_chunks=4)
    ex.calibrate(lambda g, k: spec.run_share(g, 0, k),
                 probe_units=max(spec.total_units // 8, 1),
                 workload=spec.workload, unit_cost=spec.unit_cost)
    assert ex.last_probe_runs == 0


def test_calibrate_probe_false_never_runs_the_probe():
    calls = []
    ex = HybridExecutor(device="cpu", n_chunks=4)
    ex.calibrate(lambda g, k: calls.append(g), probe_units=1,
                 workload="no-prior", probe=False)
    assert calls == [] and ex.last_probe_runs == 0


# ---------------------------------------------------------------------------
# array-level batching: merge/demux round trips
# ---------------------------------------------------------------------------
MERGE_PAYLOADS = {
    "hist": lambda s: {"n": 1 << 12, "n_bins": 64, "seed": s},
    "sort": lambda s: {"n": 1 << 10, "seed": s},
    "attention": lambda s: _attention_payload(seed=s, batch=2),
    "raycast": lambda s: {"n_rays": 256, "d": 8, "seed": 0},
}


@pytest.mark.parametrize("wl", sorted(MERGE_PAYLOADS))
@pytest.mark.parametrize("n", [3, 4])
def test_merge_demux_bit_identical(wl, n):
    """A merged batch (padded to a pow2 where the adapter pads) demuxes
    every member bitwise equal to its solo run_one on the same device,
    and the merged spec's shares agree with its run_one."""
    specs = [adapters.make_request(wl, MERGE_PAYLOADS[wl](s))
             for s in range(n)]
    with lane_device(CPU):
        merged = specs[0].merge(specs)
        assert merged is not None
        assert merged.spec.workload.endswith("@stack")
        batched = merged.spec.run_one()
        for i, s in enumerate(specs):
            np.testing.assert_array_equal(_np(merged.demux(batched, i)),
                                          _np(s.run_one()))
        k = merged.spec.total_units
        parts = [merged.spec.run_share("accel", 0, k // 2),
                 merged.spec.run_share("host", k // 2, k - k // 2)]
        whole = _np(merged.spec.combine(parts))
    np.testing.assert_array_equal(whole, _np(batched)[:whole.shape[0]])


def test_merge_declines_mismatched_shapes():
    a = adapters.make_request("hist", {"n": 1 << 12, "n_bins": 64})
    b = adapters.make_request("hist", {"n": 3000, "n_bins": 64})
    with lane_device(CPU):
        assert a.merge([a, b]) is None


def test_raycast_merge_refuses_mixed_volumes():
    a = adapters.make_request("raycast", {"n_rays": 256, "d": 8, "seed": 0})
    b = adapters.make_request("raycast", {"n_rays": 256, "d": 8, "seed": 1})
    with lane_device(CPU):
        assert a.merge([a, b]) is None
        same = adapters.make_request("raycast",
                                     {"n_rays": 256, "d": 8, "seed": 0})
        assert a.merge([a, same]) is not None


def test_conv_merge_declines_off_its_devices(monkeypatch):
    """The conv merge engages only where the solo path is ``torch_conv``
    and the grouped call is bitwise per row: not on the CPU (the search
    off runs the shift-add there, and the grouped conv is not bitwise
    at every shape), nor with ``torch_conv`` pinned."""
    specs = [adapters.make_request("conv", {"size": 64, "ksize": 3,
                                            "seed": s}) for s in range(8)]
    with lane_device(CPU):
        assert specs[0].merge(specs) is None
    monkeypatch.setenv("REPRO_TUNE_PIN_CONV2D", '{"impl": "torch_conv"}')
    pinned = [adapters.make_request("conv", {"size": 64, "ksize": 3,
                                             "seed": s}) for s in range(8, 16)]
    with lane_device(CPU):
        assert pinned[0].merge(pinned) is None
    assert "cpu" not in adapters.CONV_MERGE_DEVICES


@pytest.mark.parametrize("R, H, K", [(2, 64, 5), (3, 33, 7), (4, 48, 15)])
def test_conv2d_batched_matches_solo_torch_conv(R, H, K):
    from repro_torch.kernels.conv2d.ops import conv2d_batched
    from repro_torch.kernels.conv2d.ref import conv2d_ref

    gen = torch.Generator().manual_seed(R * H + K)
    imgs = torch.randn((R, H, H), generator=gen)
    ws = torch.randn((R, K, K), generator=gen)
    out = conv2d_batched(imgs, ws)
    for i in range(R):
        torch.testing.assert_close(out[i], conv2d_ref(imgs[i], ws[i]),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_bins", [1, 16, 256])
def test_histogram_rows_exact(n_bins):
    from repro_torch.kernels.hist.ops import histogram, histogram_rows

    x = torch.randint(-3, n_bins + 3, (5, 1000), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(n_bins))
    out = histogram_rows(x, n_bins)
    assert out.dtype == torch.int32 and out.shape == (5, n_bins)
    for i in range(5):
        assert torch.equal(out[i], histogram(x[i], n_bins))


def test_scheduler_merged_batch_results_identical():
    """A same-bucket burst through the scheduler coalesces into a merged
    execution whose per-request results are exactly the solo ones."""
    s = cpu_scheduler(max_batch=8, batch_window_s=0.05,
                      split_overhead_s=100.0)
    futs = [s.submit("sort", {"n": 1 << 10, "seed": i}) for i in range(6)]
    vals = [np.asarray(f.result(timeout=60)) for f in futs]
    s.shutdown()
    for i, v in enumerate(vals):
        solo = adapters.make_request("sort", {"n": 1 << 10, "seed": i})
        np.testing.assert_array_equal(v, np.asarray(solo.run_one()))
    assert s.stats.completed == 6
    assert s.stats.merged_batches >= 1
    assert any(f.meta["merged"] for f in futs)


def test_scheduler_serves_kernel_workloads_on_the_cpu_pair():
    """Real adapters through ``Scheduler(device="cpu")``: every value
    equals the adapter's solo run, dedicated or shared."""
    mix = [("conv", SMALL_PAYLOADS["conv"]), ("hist", SMALL_PAYLOADS["hist"]),
           ("spmv", SMALL_PAYLOADS["spmv"]), ("sort", SMALL_PAYLOADS["sort"]),
           ("bilateral", SMALL_PAYLOADS["bilateral"]),
           ("attention", PAYLOADS["attention"])]
    with cpu_scheduler(batch_window_s=0.0, split_overhead_s=0.0) as s:
        futs = [(wl, p, s.submit(wl, p)) for wl, p in mix * 2]
        got = [(wl, p, _np(f.result(timeout=60)), f) for wl, p, f in futs]
    for wl, p, value, f in got:
        with lane_device(CPU):
            solo = _np(adapters.make_request(wl, p).run_one())
        _hold(wl if wl != "sort" else "sort", value, solo)
        assert f.meta["lane"] in ("accel", "host", "shared")
    st = s.stats
    assert st.completed == len(mix) * 2 and st.in_flight == 0


# ---------------------------------------------------------------------------
# serve-LM adapter and the launcher's --hybrid / --stream
# ---------------------------------------------------------------------------
def _lm():
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo

    cfg = registry.get("kimi-k2-1t-a32b").reduced()
    return cfg, model_zoo.init(cfg, 0, device=CPU)


def test_lm_adapter_rows_and_shares_match_generate():
    from repro_torch.serve.serve_step import generate

    cfg, params = _lm()
    wl = adapters.make_lm_adapter(cfg, params, prompt_len=8, new_tokens=3,
                                  name="serve-lm/test")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 8))
    spec = adapters.make_request(wl, {"prompt": prompt})
    assert spec.total_units == 3 and spec.bucket == "B4_P8_N3"
    want = generate(cfg, params, torch.as_tensor(prompt), 3,
                    cache_len=8 + 3 + 1)
    with lane_device(CPU):
        assert torch.equal(spec.run_one(), want)
        parts = [spec.run_share("accel", 0, 2), spec.run_share("host", 2, 1)]
        assert torch.equal(spec.combine(parts), want)
    # a monolithic LM adapter has no stepper, whatever the payload says
    assert adapters.make_request(wl, {"continuous": True}).stepper is None
    with lane_device(torch.device("meta")):
        with pytest.raises(RuntimeError, match="no copy of the weights"):
            spec.run_one()


def test_run_hybrid_forced_split_gathers_both_groups():
    """One call with the rows forced half on each group: both groups
    decode in it, and its value holds both groups' rows in order."""
    from repro_torch.launch import serve
    from repro_torch.serve.serve_step import generate

    cfg, params = _lm()
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8)))
    want = generate(cfg, params, prompt, 3, cache_len=8 + 3 + 1)
    ws = serve.run_hybrid(cfg, params, prompt, 3, device="cpu",
                          plan_override=[2, 2])
    assert {g: ws.trace.group_units.get(g, 0) for g in ("accel", "host")} \
        == {"accel": 2, "host": 2}
    assert {r.group for r in ws.trace.records} == {"accel", "host"}
    assert torch.equal(ws.value, want)


def test_launcher_hybrid_and_stream_on_the_cpu_pair():
    from repro_torch.launch import serve

    argv = ["--arch", "kimi-k2-1t-a32b", "--batch", "4", "--prompt-len",
            "8", "--new-tokens", "3"]
    solo = serve.main(argv, device="cpu")
    ws = serve.main(argv + ["--hybrid"], device="cpu")
    assert torch.equal(ws.value, solo)
    assert ws.simulated and sum(ws.plan.units) == 4
    out = serve.main(argv[:2] + ["--batch", "2", "--prompt-len", "8",
                                 "--new-tokens", "3", "--stream", "--rate",
                                 "20", "--duration", "0.3"], device="cpu")
    assert out["rejected"] == 0 and out["tokens"]
    first = out["tokens"][0]
    assert all(torch.equal(t, first) for t in out["tokens"])
    st = out["stats"]
    assert st.in_flight == 0 and st.completed == len(out["tokens"]) + 1
    out = serve.main(argv[:2] + ["--batch", "1", "--prompt-len", "8",
                                 "--new-tokens", "3", "--stream",
                                 "--continuous", "--rate", "20",
                                 "--duration", "0.3"], device="cpu")
    assert out["rejected"] == 0 and out["tokens"]
    assert out["stats"].engine_steps > 0 and out["engine_placements"]
