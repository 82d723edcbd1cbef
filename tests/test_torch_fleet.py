"""The port's fleet tier (``repro_torch.serve.router`` and
``repro_torch.serve.transport``) on the CPU: consistent-hash router over
K workers, worker-process failover, spill-on-hot, brownout — and
transport parity.

The reference's ``tests/test_fleet.py``, ported.  Router *logic* is
tested against ``ToyWorker``, a scripted duck-typed transport (no
scheduler, no threads): deaths, late duplicate results and backlogs are
injected exactly where a real transport would produce them, so the
exactly-once/structured-rejection contract is checked without
subprocess latency.  ``InProcWorker`` parity drives a real toy
``Scheduler`` through the wire-message path; the ``ProcWorker`` tests
round-trip real workloads through child processes on the CPU's
simulated pair (``device="cpu"``) and compare bit-identically against
in-process dispatch and against the reference's ``hist_ref``.

Then the port against the reference: the hash ring's preference lists
and ``default_bucket`` equal the reference's (``repro.serve.router``),
also after a worker is removed; results cross the pipe as CPU tensors.
"""
import pickle
import time
from collections import namedtuple
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from repro.kernels.hist.ref import hist_ref
from repro.serve import router as ref_router
from repro_torch.core.calibration import clear_calibration_cache
from repro_torch.core.hybrid_executor import DeviceGroup, HybridExecutor
from repro_torch.kernels.common import lane_device
from repro_torch.serve import router as router_mod
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.request_queue import RequestRejected
from repro_torch.serve.router import HashRing, Router, default_bucket
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.transport import (HeartbeatMsg, InProcWorker,
                                         ProcWorker, ResultMsg, SubmitMsg,
                                         _portable)
from repro_torch.workloads import hist as hist_wl
from repro_torch.workloads import requests as adapters

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_calibration():
    clear_calibration_cache()
    yield
    router_mod.shutdown_all(timeout=10.0)
    sched_mod.shutdown_all(timeout=10.0)
    clear_calibration_cache()


def _wait(cond, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


# ---------------------------------------------------------------------------
# scripted transport fake
# ---------------------------------------------------------------------------
class ToyWorker:
    """Duck-typed fleet transport with scripted behavior.

    ``auto=True`` answers every submit synchronously (a healthy, fast
    worker); ``auto=False`` holds submits in ``held`` so the test
    controls when (or whether) results come back."""

    def __init__(self, name, auto=True):
        self.name = name
        self.auto = auto
        self.held = []
        self.transport_alive = True
        self._on_result = None
        self._on_heartbeat = None

    def start(self, on_result, on_heartbeat):
        self._on_result = on_result
        self._on_heartbeat = on_heartbeat

    def submit(self, msg: SubmitMsg) -> bool:
        if not self.transport_alive:
            return False
        if self.auto:
            self.answer(msg)
        else:
            self.held.append(msg)
        return True

    def answer(self, msg, value=None) -> None:
        """Deliver a result — including a LATE one after failover."""
        self._on_result(self.name, ResultMsg(
            msg.req_id, ok=True,
            value=("ok", self.name, msg.workload) if value is None
            else value))

    def beat(self, load=0.0, stats=None) -> None:
        self._on_heartbeat(self.name, HeartbeatMsg(
            time.monotonic(), load=load, stats=stats or {}))

    def kill(self):
        self.transport_alive = False

    def restart(self):
        self.transport_alive = True

    def shutdown(self, timeout=10.0):
        pass


def _key_for(router, workload, payload):
    return f"{workload}|{default_bucket(payload)}"


def _payload_owned_by(router, worker, workload="wl"):
    """A payload whose affinity owner is ``worker`` (ring is md5-stable,
    so scanning a few integers always finds one)."""
    for i in range(256):
        payload = {"i": i}
        if router._ring.lookup(
                _key_for(router, workload, payload)) == worker:
            return payload
    raise AssertionError(f"no key owned by {worker}")


# ---------------------------------------------------------------------------
# hashing stability
# ---------------------------------------------------------------------------
def test_ring_stable_across_instances_and_remaps_only_dead_range():
    names = ["w0", "w1", "w2"]
    r1, r2 = HashRing(vnodes=32), HashRing(vnodes=32)
    for n in names:
        r1.add(n)
        r2.add(n)
    keys = [f"wl{i}|{{'n': {j}}}" for i in range(20) for j in range(10)]
    # stability: md5 points, so two independently built rings (e.g. a
    # restarted router) agree on every placement
    assert [r1.lookup(k) for k in keys] == [r2.lookup(k) for k in keys]
    before = {k: r1.preference(k) for k in keys}
    assert all(len(p) == 3 for p in before.values())
    assert len({p[0] for p in before.values()}) == 3  # all workers used
    r1.remove("w1")
    for k in keys:
        if before[k][0] != "w1":
            # minimal disruption: survivors keep their keys
            assert r1.lookup(k) == before[k][0]
        else:
            # the dead worker's range falls to its ring successor
            assert r1.lookup(k) == before[k][1]


def test_router_routes_by_affinity_and_completes():
    a, b = ToyWorker("wa"), ToyWorker("wb")
    with Router([a, b], hb_timeout_s=60.0) as r:
        pa = _payload_owned_by(r, "wa")
        pb = _payload_owned_by(r, "wb")
        for payload, owner in ((pa, "wa"), (pb, "wb")):
            for _ in range(3):         # repeats stay affine (warm state)
                fut = r.submit("wl", payload)
                assert fut.result(timeout=5) == ("ok", owner, "wl")
        st = r.stats
        assert st.submitted == 6 and st.completed == 6
        assert st.in_flight == 0 and st.resubmits == 0 and st.spills == 0


# ---------------------------------------------------------------------------
# worker death: re-hash + re-submit, exactly-once
# ---------------------------------------------------------------------------
def test_worker_death_resubmits_and_late_result_is_noop():
    a, b = ToyWorker("wa", auto=False), ToyWorker("wb")
    with Router([a, b], hb_timeout_s=60.0, max_retries=2) as r:
        payload = _payload_owned_by(r, "wa")
        fut = r.submit("wl", payload)
        assert _wait(lambda: len(a.held) == 1)
        orig = a.held[0]
        a.kill()                       # transport down, result never sent
        # monitor detects within a tick, re-hashes onto wb, resubmits
        assert fut.result(timeout=10) == ("ok", "wb", "wl")
        st = r.stats
        assert st.worker_deaths == 1 and st.resubmits == 1
        assert r.worker_states()["wa"] == "dead"
        # the revived original answers late: unknown rid -> counted no-op
        a.restart()
        a.answer(orig, value=("ok", "wa", "late"))
        assert fut.result(timeout=1) == ("ok", "wb", "wl")  # unchanged
        assert r.stats.duplicate_results == 1
        assert r.stats.completed == 1 and r.stats.in_flight == 0
        # heartbeat resumes -> rejoin -> affinity traffic returns to wa
        a.auto = True
        a.beat()
        assert _wait(lambda: r.worker_states()["wa"] == "alive")
        assert r.stats.worker_rejoins == 1
        fut2 = r.submit("wl", payload)
        assert fut2.result(timeout=5) == ("ok", "wa", "wl")


def test_retry_budget_exhaustion_is_structured_rejection_not_hang():
    a = ToyWorker("wa", auto=False)
    with Router([a], hb_timeout_s=60.0, max_retries=0) as r:
        fut = r.submit("wl", {"i": 0})
        assert _wait(lambda: len(a.held) == 1)
        a.kill()
        with pytest.raises(RequestRejected) as ei:
            fut.result(timeout=10)     # resolves, never hangs
        assert ei.value.rejection.reason == "worker_failure"
        assert "budget" in ei.value.rejection.detail
        st = r.stats
        assert st.rejected_failure == 1 and st.in_flight == 0


def test_no_alive_worker_rejects_at_submit():
    a = ToyWorker("wa")
    with Router([a], hb_timeout_s=60.0) as r:
        a.kill()
        assert _wait(lambda: r.worker_states()["wa"] == "dead")
        fut = r.submit("wl", {"i": 0})
        with pytest.raises(RequestRejected) as ei:
            fut.result(timeout=5)
        assert ei.value.rejection.reason == "worker_failure"
        assert "no alive" in ei.value.rejection.detail


# ---------------------------------------------------------------------------
# spill-on-hot + brownout
# ---------------------------------------------------------------------------
def test_spill_on_hot_reroutes_around_backlogged_worker():
    a, b = ToyWorker("wa"), ToyWorker("wb")
    with Router([a, b], hb_timeout_s=60.0, spill_depth=4) as r:
        payload = _payload_owned_by(r, "wa")
        a.beat(load=10.0)              # wa reports a deep backlog
        b.beat(load=1.0)
        fut = r.submit("wl", payload)
        assert fut.result(timeout=5) == ("ok", "wb", "wl")  # spilled
        assert r.stats.spills == 1
        a.beat(load=0.0)               # backlog drained: affinity back
        fut2 = r.submit("wl", payload)
        assert fut2.result(timeout=5) == ("ok", "wa", "wl")
        assert r.stats.spills == 1


def test_brownout_sheds_best_effort_while_degraded():
    a, b = ToyWorker("wa"), ToyWorker("wb")
    with Router([a, b], hb_timeout_s=60.0) as r:
        ok = r.submit("wl", {"i": 1}, priority=-1)
        ok.result(timeout=5)           # healthy fleet: served normally
        b.kill()
        assert _wait(lambda: r.worker_states()["wb"] == "dead")
        shed = r.submit("wl", {"i": 1}, priority=-1)
        with pytest.raises(RequestRejected) as ei:
            shed.result(timeout=5)
        assert ei.value.rejection.reason == "brownout"
        assert r.stats.shed_brownout == 1
        # normal-priority traffic still flows to the survivor
        served = r.submit("wl", _payload_owned_by(r, "wb"))
        assert served.result(timeout=5) == ("ok", "wa", "wl")


# ---------------------------------------------------------------------------
# heartbeat-detected wedge (process alive, beats stopped)
# ---------------------------------------------------------------------------
def test_wedged_worker_goes_suspect_then_dead_and_work_fails_over():
    a, b = ToyWorker("wa", auto=False), ToyWorker("wb")
    with Router([a, b], hb_timeout_s=0.15, max_retries=2) as r:
        payload = _payload_owned_by(r, "wa")
        fut = r.submit("wl", payload)
        assert _wait(lambda: len(a.held) == 1)
        # wa's transport stays up but it never beats again (SIGSTOP /
        # GC pause); wb keeps beating.  suspect at ~1x timeout, dead at
        # ~2x, then the held request fails over.
        deadline = time.monotonic() + 10.0
        while not fut.done() and time.monotonic() < deadline:
            b.beat()
            time.sleep(0.03)
        assert fut.result(timeout=1) == ("ok", "wb", "wl")
        st = r.stats
        assert st.worker_suspects >= 1 and st.worker_deaths >= 1
        assert st.resubmits >= 1 and st.in_flight == 0


# ---------------------------------------------------------------------------
# transport parity: router + wire messages vs direct in-process dispatch
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
    steal: object = None
    bucket: str = "b"


def _toy_scheduler():
    def factory(workload, payload):
        return ToySpec(
            workload=workload, total_units=4,
            run_one=lambda: ("done", workload, payload["i"]),
            run_share=lambda g, s, k: list(range(s, s + k)),
            combine=lambda outs: [x for o in outs for x in o],
            bucket=f"{workload}/b")

    groups = [DeviceGroup("accel", [], "accel"),
              DeviceGroup("host", [], "host")]
    # split_overhead_s=100: every request runs dedicated.  The span
    # factor the port's scheduler probes on the CPU can fall under the
    # 1.5 that makes this toy's first request a split (whose combine()
    # returns the shares, not run_one's value), and the first
    # scheduler's measured unit times then steer the second one's
    # placement: both schedulers must take the same path for the
    # values to be comparable.
    s = Scheduler(executor=HybridExecutor(groups=groups, n_chunks=4),
                  spec_factory=factory, batch_window_s=0.0,
                  split_overhead_s=100.0)
    s._ex.cache.put("wl", "accel", 1e-3)
    s._ex.cache.put("wl", "host", 2e-3)
    return s


def test_inproc_worker_parity_with_direct_dispatch():
    direct = _toy_scheduler()
    direct.start()
    want = [direct.submit("wl", {"i": i}).result(timeout=10)
            for i in range(4)]
    direct.shutdown()

    w = InProcWorker("w0", sched_factory=_toy_scheduler,
                     hb_interval_s=0.05)
    with Router([w], hb_timeout_s=60.0) as r:
        got = [r.submit("wl", {"i": i}).result(timeout=10)
               for i in range(4)]
    assert got == want                 # same values through the wire
    assert r.stats.completed == 4 and r.stats.in_flight == 0


def _own_stores(tmp_path):
    """A child's own calibration and tune stores, under ``tmp_path``
    (not the test process's, which other tests in it write)."""
    return {"REPRO_CALIB_CACHE": str(tmp_path / "calibration.json"),
            "REPRO_TUNE_CACHE": str(tmp_path / "autotune.json")}


def test_proc_worker_parity_with_local_scheduler(tmp_path):
    """One real request through a child *process* (pipe transport, full
    Scheduler in the child, on the CPU's simulated pair) must return
    bit-identically to local dispatch — the value moved to the host at
    the boundary, same kernel result."""
    payload = {"n": 1 << 12, "n_bins": 32}
    local = Scheduler(device="cpu")
    local.start()
    want = local.submit("hist", payload).result(timeout=120)
    local.shutdown()

    w = ProcWorker("pw0", env=_own_stores(tmp_path), hb_interval_s=0.2,
                   device="cpu")
    r = Router([w], hb_timeout_s=30.0)
    try:
        r.start()
        fut = r.submit("hist", payload)
        got = fut.result(timeout=180)
        assert _wait(lambda: r.worker_stats().get("pw0"))  # beats flow
    finally:
        r.shutdown(timeout=30.0)
    assert isinstance(got, torch.Tensor) and got.device == CPU
    assert torch.equal(got, want.cpu())
    assert r.stats.completed == 1 and r.stats.in_flight == 0


def test_fleet_env_knobs_apply(monkeypatch):
    monkeypatch.setenv("REPRO_FLEET_VNODES", "8")
    monkeypatch.setenv("REPRO_FLEET_MAX_RETRIES", "5")
    monkeypatch.setenv("REPRO_FLEET_HB_TIMEOUT_S", "9.0")
    monkeypatch.setenv("REPRO_FLEET_SPILL_DEPTH", "3")
    r = Router([ToyWorker("wa")])
    try:
        assert r._ring.vnodes == 8
        assert r.max_retries == 5
        assert r.hb_timeout_s == 9.0
        assert r.spill_depth == 3.0
    finally:
        r.shutdown(timeout=5.0)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def _keys():
    wls = ["conv", "hist", "spmv", "sort", "attention"]
    payloads = [{"n": 1 << j, "n_bins": 64} for j in range(10, 30)] + \
        [{"size": 128 * j, "ksize": 5} for j in range(1, 21)]
    return [f"{w}|{default_bucket(p)}" for w in wls for p in payloads]


@pytest.mark.parametrize("names", [["fw0", "fw1"],
                                   ["w0", "w1", "w2"],
                                   ["a", "b", "c", "d", "coldw"]],
                         ids=["2", "3", "5"])
def test_hash_ring_equals_the_reference(names):
    keys = _keys()
    assert len(keys) == 200
    ours, ref = HashRing(vnodes=64), ref_router.HashRing(vnodes=64)
    for n in names:
        ours.add(n)
        ref.add(n)
    assert [ours.preference(k) for k in keys] == \
        [ref.preference(k) for k in keys]
    ours.remove(names[0])
    ref.remove(names[0])
    assert [ours.preference(k) for k in keys] == \
        [ref.preference(k) for k in keys]
    assert all(ours.lookup(k) != names[0] for k in keys)


def test_default_bucket_equals_the_reference():
    payloads = [None, 3, "x", {"n": 4, "n_bins": 32},
                {"b": [1, 2], "a": {"z": 1.5, "y": None}},
                {"size": 3600, "ksize": 15, "seed": 7},
                {"obj": object}, {1: 2, "1": 3}]
    for p in payloads:
        assert default_bucket(p) == ref_router.default_bucket(p), p


def test_proc_worker_hist_equals_the_reference_hist_ref(tmp_path):
    """A hist request through a child process on the CPU equals the
    reference's ``hist_ref`` on the same numpy keys, exactly."""
    import jax.numpy as jnp

    payload = {"n": 1 << 14, "n_bins": 64}
    keys = hist_wl.make_inputs(payload["n"], payload["n_bins"])
    want = np.asarray(hist_ref(jnp.asarray(keys), payload["n_bins"]))
    w = ProcWorker("pw0", env=_own_stores(tmp_path), hb_interval_s=0.2,
                   device="cpu")
    r = Router([w], hb_timeout_s=30.0)
    try:
        r.start()
        got = r.submit("hist", payload).result(timeout=180)
        # the child counts the completion just after it sends the result
        assert _wait(lambda: r.refresh_stats(timeout=5.0)["pw0"].get(
            "completed") == 1, timeout=60.0)
        beat = r.worker_stats()["pw0"]
    finally:
        r.shutdown(timeout=30.0)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the child reports its own CUDA memory and kernel launches (none on
    # the CPU) beside its scheduler's counters
    assert beat["cuda_memory_reserved"] == 0.0
    assert beat["launches.hist"] == 0.0
    assert beat["entry_launches.hist_priv_i32"] == 0.0


def test_inproc_and_proc_workers_return_identical_values(tmp_path):
    """The same conv request through an ``InProcWorker`` and a
    ``ProcWorker`` (both on the CPU's simulated pair) gives
    bit-identical CPU tensors — the reference's transport contract."""
    payload = {"size": 64, "ksize": 5}
    with lane_device(CPU):
        solo = adapters.make_request("conv", payload).run_one()
    got = {}
    for w in (InProcWorker("iw", sched_factory=lambda: Scheduler(
            device="cpu"), hb_interval_s=0.2),
              ProcWorker("pw", env=_own_stores(tmp_path),
                         hb_interval_s=0.2, device="cpu")):
        r = Router([w], hb_timeout_s=30.0)
        try:
            r.start()
            got[w.name] = r.submit("conv", payload).result(timeout=180)
        finally:
            r.shutdown(timeout=30.0)
    assert got["iw"].device == got["pw"].device == CPU
    assert torch.equal(got["iw"], got["pw"])
    assert torch.equal(got["pw"], solo)


def test_proc_worker_without_a_gpu_fails_at_start(tmp_path):
    """No fallback: a child asked for the card on a host without one
    exits at start, and the router sees a dead worker, never a silent
    CPU worker."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the child would start on it")
    w = ProcWorker("pw0", env=_own_stores(tmp_path), hb_interval_s=0.2)
    r = Router([w], hb_timeout_s=30.0, max_retries=0)
    try:
        r.start()
        assert _wait(lambda: not w.transport_alive, timeout=60.0)
        assert w._proc.returncode not in (None, 0)
        assert _wait(lambda: r.worker_states()["pw0"] == "dead")
        with pytest.raises(RequestRejected) as ei:
            r.submit("hist", {"n": 1 << 10}).result(timeout=10)
        assert ei.value.rejection.reason == "worker_failure"
    finally:
        r.shutdown(timeout=30.0)


Pair = namedtuple("Pair", "a b")


def test_portable_moves_every_tensor_to_the_host():
    bf = torch.arange(4, dtype=torch.bfloat16)
    arr = np.arange(3, dtype=np.float32)
    value = {"t": bf, "l": [torch.ones(2), 3], "n": arr,
             "p": Pair(torch.zeros(1, dtype=torch.int32), "x"),
             "tup": (torch.ones(1, requires_grad=True),)}
    out = _portable(value)
    assert out["t"].dtype == torch.bfloat16 and out["t"].device == CPU
    assert torch.equal(out["t"], bf)
    assert out["n"] is arr                     # numpy passes as it is
    assert isinstance(out["p"], Pair) and out["p"].b == "x"
    assert not out["tup"][0].requires_grad
    assert out["l"][1] == 3


def test_wire_messages_pickle_under_the_port_module():
    msg = SubmitMsg(req_id=1, workload="hist", payload={"n": 8},
                    slo="batch", trace_id="t")
    blob = pickle.dumps(msg)
    assert b"repro_torch.serve.transport" in blob
    assert pickle.loads(blob) == msg
    assert type(msg).__module__ == "repro_torch.serve.transport"
