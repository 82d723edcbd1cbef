"""The port's continuous-batching engine (``repro_torch.serve.continuous``)
against the JAX reference's contracts, on the CPU.

The reference's ``tests/test_continuous.py`` at three configs: kimi-k2
``reduced()`` (attention + MoE, so K8's plain version runs), the
reference's own fixture config, minicpm3-4b ``reduced()`` (MLA), and
xlstm-350m ``reduced()`` (recurrent caches); prompt
8, six new tokens.  Join/evict is bitwise a solo ``generate``; the iteration
steppers (listrank, lbm, dither) are bitwise their solo ``run_one``
(lbm held to solo lbm stepping); a fresh scheduler places the engine's
lanes with zero probes; preemption at iteration boundaries, the
accounting invariant and shutdown hold.  Parity with the reference:
``decode_step`` at a (B,) position tensor equals B separate ``int``
steps bitwise (a sliding window past its wrap included), the engine's
tokens equal the reference's ``generate`` under ``jax.disable_jit()`` on
parameters carried by ``from_jax`` (a token may differ only at a near
tie, the models' margin rule), and the LM cost priors equal the
reference's.  Sampling: greedy at temperature 0, draws from
``softmax(logits / T)`` above it.
"""
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core import cost_model as jax_cost_model
from repro.models import model_zoo as jax_zoo
from repro.models import param as jax_param
from repro.serve import serve_step as jax_serve
from repro_torch.configs import registry
from repro_torch.core import cost_model
from repro_torch.core.calibration import clear_calibration_cache
from repro_torch.core.hybrid_executor import DeviceGroup, HybridExecutor
from repro_torch.ft.failure import FailureInjector
from repro_torch.kernels.common import current_device, lane_device
from repro_torch.models import model_zoo
from repro_torch.models.from_jax import params_from_numpy
from repro_torch.models.param import leaves
from repro_torch.obs import get_recorder
from repro_torch.serve import continuous
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.request_queue import (Request, RequestRejected)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.serve_step import (generate, make_serve_step,
                                          make_slot_step, sample_tokens)
from repro_torch.workloads import requests as adapters
from torch_ref_pin import ref_op_by_op

CPU = torch.device("cpu")
KIMI = "kimi-k2-1t-a32b"
MINICPM = "minicpm3-4b"
XLSTM = "xlstm-350m"
PROMPT_LEN, NEW_TOKENS = 8, 6
CACHE_LEN = PROMPT_LEN + NEW_TOKENS + 1
BF16_ATOL = 0.25


@pytest.fixture(autouse=True)
def _fresh_state():
    clear_calibration_cache()
    yield
    sched_mod.shutdown_all(timeout=10.0)
    clear_calibration_cache()


@pytest.fixture(scope="module", params=[KIMI, MINICPM, XLSTM])
def lm(request):
    """One reduced arch + registered continuous adapter per module and
    arch: the stepper is shared state (every request of the workload
    stacks into one engine).  kimi-k2 (attention + MoE), minicpm3-4b
    (MLA, the reference's own fixture config) and xlstm-350m (mLSTM and
    sLSTM: recurrent states, no sequence axis, in the slots)."""
    cfg = registry.get(request.param).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    wl = adapters.make_continuous_lm_adapter(
        cfg, params, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
        name=f"serve-lm-cb/test-{request.param}")
    assert adapters.wait_precompiled(timeout=300)
    yield cfg, params, wl
    adapters.unregister(wl)


def _solo(cfg, params, prompt):
    return generate(cfg, params, torch.as_tensor(prompt), NEW_TOKENS,
                    cache_len=CACHE_LEN)


def _prompt(wl, payload):
    return adapters.make_request(wl, payload).arrays[0].host[0]


def _two_groups():
    """The simulated pair on the CPU: both lanes on one device."""
    return [DeviceGroup("accel", [CPU], "accel"),
            DeviceGroup("host", [CPU], "host")]


def _sched(**kw):
    kw.setdefault("shared_span_factor", 1.0)
    return Scheduler(groups=_two_groups(), **kw)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# ---------------------------------------------------------------------------
# join / evict bit-identity vs solo decode
# ---------------------------------------------------------------------------
def test_lm_engine_join_evict_bit_identical(lm):
    """A burst of same-bucket LM requests stacks into one slot-batched
    step loop; every demuxed output equals its solo generate() bitwise,
    and the step count shows actual stacking (fewer batched steps than
    row-steps)."""
    cfg, params, wl = lm
    sched = _sched()
    futs = [sched.submit(wl, {"batch": 1, "seed": s}) for s in range(5)]
    outs = [f.result(timeout=300) for f in futs]
    snap = sched.stats.snapshot()
    sched.shutdown()
    for s, out in enumerate(outs):
        want = _solo(cfg, params, _prompt(wl, {"batch": 1, "seed": s}))
        assert out.dtype == torch.int32 and out.shape == (1, NEW_TOKENS + 1)
        assert torch.equal(out, want)
    assert snap["engine_joins"] == 5
    assert snap["engine_evictions"] == 5
    # 5 rows x 6 steps = 30 row-steps; stacking must beat one-at-a-time
    assert 0 < snap["engine_steps"] < 5 * NEW_TOKENS


def test_lm_engine_multirow_request_demux(lm):
    """A batch-3 request spreads over three slots; assemble restores row
    order exactly."""
    cfg, params, wl = lm
    sched = _sched()
    out = sched.submit(wl, {"batch": 3, "seed": 9}).result(timeout=300)
    sched.shutdown()
    want = _solo(cfg, params, _prompt(wl, {"batch": 3, "seed": 9}))
    assert torch.equal(out, want)


def test_lm_engine_rows_at_different_depths(lm):
    """Requests that join while others are mid-decode sit at other
    positions in the same step; each still equals its solo run."""
    cfg, params, wl = lm
    sched = _sched()
    first = sched.submit(wl, {"batch": 2, "seed": 20})
    eng = None
    assert _wait(lambda: sched._engines)
    eng = next(iter(sched._engines.values()))
    assert _wait(lambda: eng.steps >= 2 or first.done())
    late = [sched.submit(wl, {"batch": 1, "seed": s}) for s in (21, 22)]
    outs = [f.result(timeout=300) for f in [first] + late]
    sched.shutdown()
    for s, out in zip((20, 21, 22), outs):
        p = {"batch": 2 if s == 20 else 1, "seed": s}
        assert torch.equal(out, _solo(cfg, params, _prompt(wl, p)))


def test_lm_engine_disabled_falls_back_to_monolithic(lm, monkeypatch):
    """REPRO_SERVE_CONTINUOUS=0 routes the same workload through the
    monolithic run_one path — same results, no engine."""
    monkeypatch.setenv("REPRO_SERVE_CONTINUOUS", "0")
    cfg, params, wl = lm
    sched = _sched()
    out = sched.submit(wl, {"batch": 1, "seed": 4}).result(timeout=300)
    snap = sched.stats.snapshot()
    sched.shutdown()
    assert torch.equal(out, _solo(cfg, params,
                                  _prompt(wl, {"batch": 1, "seed": 4})))
    assert snap["engine_steps"] == 0 and not sched.engine_placements


@pytest.mark.parametrize("value,on", [(None, True), ("1", True),
                                      ("0", False), ("off", False),
                                      ("false", False), ("no", False)])
def test_continuous_enabled_reads_the_knob(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("REPRO_SERVE_CONTINUOUS", raising=False)
    else:
        monkeypatch.setenv("REPRO_SERVE_CONTINUOUS", value)
    assert sched_mod.continuous_enabled() is on


# ---------------------------------------------------------------------------
# disaggregated cold-start placement, zero probes
# ---------------------------------------------------------------------------
def test_cold_start_places_engine_with_zero_probes(lm):
    """A fresh scheduler picks the prefill and decode lanes purely from
    the CostTerms priors — no probe runs."""
    _, _, wl = lm
    sched = _sched()
    sched.submit(wl, {"batch": 1, "seed": 2}).result(timeout=300)
    snap = sched.stats.snapshot()
    plan = sched.engine_placements.get(wl)
    sched.shutdown()
    assert snap["probe_runs"] == 0
    assert plan is not None
    assert plan.prefill_group in ("accel", "host")
    assert plan.decode_group in ("accel", "host")
    assert plan.est_prefill_s > 0 and plan.est_decode_s > 0


def test_engine_lanes_priced_like_the_reference(lm):
    """The lane plan is the reference's rule on the port's priors:
    prefill on the projected-fastest lane, decode on the other, each
    estimate the prior times the group's slowdown."""
    _, _, wl = lm
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    sched = Scheduler(device="cpu", shared_span_factor=1.0)
    plan = sched._plan_engine_lanes(stepper)
    sched.shutdown()
    slow = {g.name: g.slowdown for g in sched.groups}
    assert (plan.prefill_group, plan.decode_group) == ("accel", "host")
    assert plan.est_prefill_s == pytest.approx(
        cost_model.predict(stepper.prefill_cost, CPU) * slow["accel"])
    assert plan.est_decode_s == pytest.approx(
        cost_model.predict(stepper.decode_cost, CPU) * slow["host"])


# ---------------------------------------------------------------------------
# iterative adapters become preemptible + stackable
# ---------------------------------------------------------------------------
def _lbm_solo(d, n_steps, seed):
    from repro_torch.workloads import lbm

    cur = adapters._lbm_state(d, seed).on(CPU)[0]
    for _ in range(n_steps):
        cur = lbm.step_all(cur)
    return cur


def _listrank_solo(n, seed):
    from repro_torch.workloads import listrank as lr
    return lr.pointer_jump_rank(adapters._listrank_inputs(n, seed)
                                .on(CPU)[0]).numpy()


def _dither_solo(h, w, seed):
    from repro_torch.workloads import dither
    return dither.fsd_dither(adapters._dither_inputs(h, w, seed).on(CPU)[0])


@pytest.mark.parametrize("wl,payload,solo", [
    ("listrank", {"n": 1 << 10, "seed": 3, "continuous": True},
     lambda: _listrank_solo(1 << 10, 3)),
    ("lbm", {"d": 8, "n_steps": 3, "seed": 1, "continuous": True},
     lambda: _lbm_solo(8, 3, 1)),
    ("dither", {"h": 32, "w": 32, "seed": 2, "continuous": True},
     lambda: _dither_solo(32, 32, 2)),
])
def test_iterative_engine_bit_identical(wl, payload, solo):
    sched = _sched()
    out = sched.submit(wl, payload).result(timeout=300)
    snap = sched.stats.snapshot()
    sched.shutdown()
    np.testing.assert_array_equal(np.asarray(out), np.asarray(solo()))
    assert snap["engine_steps"] > 0


@pytest.mark.parametrize("wl,payload,solo", [
    ("listrank", {"n": 1 << 10, "seed": 3},
     lambda: __import__("repro.workloads.listrank", fromlist=["x"])
     .pointer_jump_rank(adapters_ref()._listrank_inputs(1 << 10, 3))),
    ("dither", {"h": 32, "w": 32, "seed": 2},
     lambda: __import__("repro.workloads.dither", fromlist=["x"])
     .fsd_dither(adapters_ref()._dither_inputs(32, 32, 2))),
])
def test_iterative_engine_matches_the_reference_run_one(wl, payload, solo):
    """listrank and dither through the port's engine equal the
    reference's solo run on the same seed, exactly (lbm: the
    reference's own engine fails its tests, so the port's is held to
    solo stepping above)."""
    sched = _sched()
    out = sched.submit(wl, dict(payload, continuous=True)).result(
        timeout=300)
    sched.shutdown()
    np.testing.assert_array_equal(np.asarray(out), np.asarray(solo()))


def adapters_ref():
    from repro.workloads import requests as ref_adapters
    return ref_adapters


def test_dither_wavefront_slots_at_different_steps():
    """The batched wavefront step: two slots a few steps apart, and a
    slot past its last step, each equal the solo dither bitwise."""
    from repro_torch.workloads import dither

    h, w = 9, 14
    imgs = [torch.as_tensor(dither.make_image(h, w, s)) for s in (1, 2)]
    rows = [dither.wavefront_row(i) for i in imgs]
    state = tuple(torch.stack([r[k] for r in rows]) for k in range(4))
    T = dither.n_wavefront_steps(h, w)
    for _ in range(3):                       # slot 1 joins 3 steps late
        state = dither.wavefront_step(state, h, w)
    for k in range(4):
        state[k][1] = rows[1][k]
    for _ in range(T + 3):                   # slot 0 runs 6 steps over
        state = dither.wavefront_step(state, h, w)
    for s, img in enumerate(imgs):
        out = dither.wavefront_out(tuple(a[s] for a in state), h, w)
        assert torch.equal(out, dither.fsd_dither(img))


def test_iterative_requests_stack_cross_request():
    """Two live lbm requests share the slot state (max_live == 2) and
    still both match the sequential solo run."""
    sched = _sched()
    n_steps = 48
    futs = [sched.submit("lbm", {"d": 8, "n_steps": n_steps, "seed": s,
                                 "continuous": True})
            for s in (1, 2)]
    outs = [f.result(timeout=300) for f in futs]
    eng = next(iter(sched._engines.values()))
    snap = eng.snapshot()
    sched.shutdown()
    for s, out in zip((1, 2), outs):
        assert torch.equal(out, _lbm_solo(8, n_steps, s))
    assert snap["max_live"] == 2
    assert snap["evictions"] == 2
    # stacked: strictly fewer batched steps than sequential row-steps
    assert snap["steps"] < 2 * n_steps


def test_step_loop_preempts_at_iteration_boundaries():
    """The step loop releases its lane locks between steps; holding
    those locks from outside stalls it mid-request (at a step boundary,
    not mid-step) and releasing lets it finish."""
    sched = _sched()
    fut = sched.submit("lbm", {"d": 8, "n_steps": 120, "seed": 5,
                               "continuous": True})
    assert _wait(lambda: sched._engines, timeout=60)
    eng = next(iter(sched._engines.values()))
    assert _wait(lambda: eng.steps >= 3, timeout=60), \
        "engine never started stepping"

    for lk in eng.step_locks:           # preempt: take the decode lane
        lk.acquire()
    try:
        s0 = eng.steps
        time.sleep(0.2)
        # at most one in-flight step finishes; the loop then blocks
        assert eng.steps <= s0 + 1
        assert not fut.done()
    finally:
        for lk in reversed(eng.step_locks):
            lk.release()

    out = fut.result(timeout=300)
    sched.shutdown()
    assert torch.equal(out, _lbm_solo(8, 120, 5))


def test_engine_yields_to_urgent_latency_work():
    """A latency-class deadline execution dispatched at the engine's
    lane makes the step loop pause at its next boundary (counted as a
    preemption), and the urgent count drains once it ran."""
    sched = _sched()
    fut = sched.submit("lbm", {"d": 8, "n_steps": 200, "seed": 6,
                               "continuous": True})
    assert _wait(lambda: sched._engines, timeout=60)
    eng = next(iter(sched._engines.values()))
    assert _wait(lambda: eng.steps >= 2, timeout=60)
    urgent = sched.submit("hist", {"n": 1 << 10, "n_bins": 16},
                          deadline=30.0, priority=1)
    urgent.result(timeout=60)
    fut.result(timeout=300)
    snap = sched.stats.snapshot()
    sched.shutdown()
    assert all(v == 0 for v in sched._urgent.values())
    assert snap["engine_preemptions"] == eng.preemptions


# ---------------------------------------------------------------------------
# accounting under step-quantum dispatch
# ---------------------------------------------------------------------------
def test_accounting_invariant_under_step_quantum(lm):
    """submitted == completed + failed + rejected + shed + in-flight at
    every observation point, and in-flight drains to zero."""
    _, _, wl = lm
    sched = _sched()
    futs = [sched.submit(wl, {"batch": 1, "seed": s}) for s in range(4)]
    futs.append(sched.submit("listrank", {"n": 1 << 10, "seed": 0,
                                          "continuous": True}))
    futs.append(sched.submit("dither", {"h": 32, "w": 32, "seed": 1,
                                        "continuous": True}))
    st = sched.stats
    assert st.submitted == (st.completed + st.failed + st.rejected_full
                            + st.rejected_shutdown + st.shed_deadline
                            + st.in_flight)
    for f in futs:
        f.result(timeout=300)
    assert _wait(lambda: st.in_flight == 0)
    sched.shutdown()
    assert st.submitted == 6 == st.completed
    assert st.in_flight == 0


def test_engine_shutdown_finishes_in_flight(lm):
    """shutdown() resolves every submitted future (finished or
    structured-rejected), never orphans one."""
    _, _, wl = lm
    sched = _sched()
    futs = [sched.submit(wl, {"batch": 1, "seed": s}) for s in range(3)]
    sched.shutdown()                     # immediately, mid-decode
    for f in futs:
        try:
            f.result(timeout=300)        # resolved, not hung
        except RequestRejected:
            pass                         # structured shutdown rejection
    assert sched.stats.in_flight == 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("serve-cb-")]


def test_failed_step_rejects_its_rows_instead_of_hanging():
    """A stepper whose step raises fails the requests its live rows
    hold; the engine keeps serving."""
    class _Boom:
        workload = "toy-boom"
        n_slots = 2

        def init_slots(self):
            return {}

        def prefill(self, spec):
            return [(None, None, 3)]

        def insert(self, state, slot, row_state):
            return state

        def step(self, state):
            raise ValueError("boom")

    failed = []
    eng = continuous.ContinuousEngine(
        _Boom(), resolve=lambda req, v, t0: req.future._resolve(v),
        reject=lambda req, e: (req.future._reject(e), failed.append(e)))
    try:
        r = Request(workload="toy-boom", payload=None)
        assert eng.submit(r, None, 0.0)
        with pytest.raises(ValueError, match="boom"):
            r.future.result(timeout=10)
        assert eng.wait_idle(timeout=10)
    finally:
        eng.shutdown()
    assert len(failed) == 1 and eng.live_rows == 0


# ---------------------------------------------------------------------------
# the engine route's fault paths (reference test_fault_tolerance.py,
# test_obs.py)
# ---------------------------------------------------------------------------
def test_engine_route_all_lanes_dead_structured_rejection():
    """A dead-lane window during engine routing is a structured
    rejection, not a dispatcher-crashing RuntimeError that hangs every
    queued future."""
    from repro_torch.core.cost_model import CostTerms

    def factory(workload, payload):
        return SimpleNamespace(
            workload=workload, bucket="sb", total_units=1,
            unit_cost=None, comm_cost=0.0,
            stepper=SimpleNamespace(workload=workload, n_slots=2,
                                    prefill_cost=CostTerms(),
                                    decode_cost=CostTerms()))

    groups = [DeviceGroup("accel", [CPU], "accel")]
    s = Scheduler(executor=HybridExecutor(groups=groups, n_chunks=2),
                  spec_factory=factory, batch_window_s=0.0, max_batch=1,
                  shared_span_factor=1.0,
                  failure_injector=FailureInjector(kill={0: "accel"}))
    fut = s.submit("toy-cb", None)
    with pytest.raises(RequestRejected) as ei:
        fut.result(timeout=10)
    assert ei.value.rejection.reason == "lane_failure"
    assert "engine" in ei.value.rejection.detail
    st = s.stats
    assert st.rejected_failure == 1
    assert st.failed == 0
    s.shutdown()
    assert st.in_flight == 0


def test_engine_cancels_externally_resolved_rows_at_boundary():
    """Rows whose future resolved elsewhere (hedge winner, shutdown) are
    dropped at the next step boundary — a live row frees its slot, a
    ready row never takes one — without running finish()."""
    class _ToyStepper:
        workload = "toy-cb"
        n_slots = 1

        def init_slots(self):
            return {"steps": 0}

        def prefill(self, spec):
            return [(None, None, spec["n_steps"])]

        def insert(self, state, slot, row_state):
            return state

        def step(self, state):
            time.sleep(0.002)
            return {"steps": state["steps"] + 1}, None

        def finish(self, state, slot, first_out, collected):
            return "finished"

        def assemble(self, rows):
            return rows[0]

    finished = []
    cancelled = {"n": 0}
    eng = continuous.ContinuousEngine(
        _ToyStepper(),
        resolve=lambda req, v, t0: (req.future._resolve(v),
                                    finished.append(req.payload)),
        reject=lambda req, e: req.future._reject(e),
        hooks={"on_cancel":
               lambda k: cancelled.__setitem__("n", cancelled["n"] + k)})
    try:
        a = Request(workload="toy-cb", payload="A")
        assert eng.submit(a, {"n_steps": 2000}, 0.0)
        assert _wait(lambda: eng.snapshot()["joins"] >= 1)
        b = Request(workload="toy-cb", payload="B")
        assert eng.submit(b, {"n_steps": 2}, 0.0)   # queues behind A
        b.future._resolve("hedged elsewhere")       # ready-row cancel
        a.future._resolve("hedged elsewhere")       # live-row cancel
        assert eng.wait_idle(timeout=10)
    finally:
        eng.shutdown()
    assert eng.cancellations == 2
    assert cancelled["n"] == 2
    assert finished == []                  # finish() never ran


@pytest.fixture
def live_recorder():
    rec = get_recorder()
    was = rec.enabled
    rec.enabled = True
    rec.clear()
    yield rec
    rec.enabled = was
    rec.clear()


def test_engine_preemption_cancel_carries_trace_id(live_recorder):
    """Resolving a live continuous request's future externally (the
    hedge-winner/preemption path) frees its slot at a step boundary and
    emits an engine_cancel instant with the request's trace_id."""
    sched = _sched()
    fut = sched.submit("lbm", {"d": 8, "n_steps": 120, "seed": 5,
                               "continuous": True},
                       trace_id="tid-preempt")
    assert _wait(lambda: sched._engines, timeout=60)
    eng = next(iter(sched._engines.values()))
    assert _wait(lambda: eng.steps >= 3, timeout=60)
    fut._resolve("preempted")          # external resolve mid-decode
    assert _wait(lambda: any(
        e["name"] == "engine_cancel"
        and e["args"].get("trace_id") == "tid-preempt"
        for e in live_recorder.events()), timeout=30)
    # the request was resolved outside the scheduler, so its accounting
    # still counts it in flight: a drain would wait out its timeout
    sched.shutdown(abort=True)
    names = {e["name"] for e in live_recorder.events()}
    assert {"prefill", "engine_step", "engine_join"} <= names


# ---------------------------------------------------------------------------
# devices: the slot state lives on the decode lane's device
# ---------------------------------------------------------------------------
def test_lm_stepper_refuses_a_lane_on_another_device(lm):
    """A step or an insert from a lane on another device raises instead
    of copying every step; a lane with no weight copy raises."""
    _, _, wl = lm
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    with lane_device(CPU):
        state = stepper.init_slots()
        spec = adapters.make_request(wl, {"batch": 1, "seed": 0})
        (row, _, _), = stepper.prefill(spec)
    meta = torch.device("meta")
    with lane_device(meta):
        with pytest.raises(RuntimeError, match="slot state is on cpu"):
            stepper.step(state)
        with pytest.raises(RuntimeError, match="slot state is on cpu"):
            stepper.insert(state, 0, row)
        with pytest.raises(RuntimeError, match="no copy of the weights"):
            stepper.init_slots()
    with lane_device(CPU):
        stepper.insert(state, 1, row)
        stepper.step(state)
        assert int(state["pos"][1]) == PROMPT_LEN + 1


def test_lm_stepper_dead_slots_stay_in_the_cache():
    """Dead slots step on forever; their positions stop at the cache's
    last slot, so no write leaves the cache."""
    cfg = registry.get(KIMI).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    stepper = continuous.LMStepper(cfg, params, prompt_len=4, new_tokens=2,
                                   n_slots=2)
    with lane_device(CPU):
        state = stepper.init_slots()
        for _ in range(3 * stepper.cache_len):
            state, outs = stepper.step(state)
    assert outs.shape == (2,)
    assert int(state["pos"].max()) == stepper.cache_len - 1


# ---------------------------------------------------------------------------
# per-row decode positions through the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 4])
def test_decode_step_row_positions_equal_int_steps(window):
    """One ``decode_step`` over B rows at a (B,) position tensor equals
    B separate one-row steps at each row's ``int`` position, bitwise —
    logits and the cache rows written; a window of 4 past its wrap."""
    cfg = registry.get(KIMI).reduced().replace(sliding_window=window)
    params = model_zoo.init(cfg, 0, device=CPU)
    rng = np.random.default_rng(11)
    B, P = 3, 5
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)))
    L = 16
    depth = [0, 2, 5]                 # extra tokens each row decoded
    rows, pos = [], []
    with torch.inference_mode():
        for b in range(B):
            _, c = model_zoo.prefill(cfg, params, {"tokens": prompts[b:b + 1]},
                                     cache_len=L)
            for t in range(depth[b]):
                tok = torch.as_tensor([[int(rng.integers(cfg.vocab_size))]])
                model_zoo.decode_step(cfg, params, tok, c, P + t)
            rows.append(c)
            pos.append(P + depth[b])
        stacked = continuous._tree_map(
            lambda *a: torch.cat(a, dim=0).clone(), *rows)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)))
        logits, _ = model_zoo.decode_step(cfg, params, toks, stacked,
                                          torch.as_tensor(pos))
        for b in range(B):
            lg, c = model_zoo.decode_step(cfg, params, toks[b:b + 1],
                                          rows[b], pos[b])
            assert torch.equal(logits[b:b + 1], lg), f"row {b}"
            got = continuous._tree_map(lambda a: a[b:b + 1], stacked)
            for x, y in zip(leaves(got), leaves(c)):
                assert torch.equal(x, y), f"row {b}'s cache"
    if window:
        assert max(pos) >= window     # a ring buffer past its wrap


def test_int_position_path_is_unchanged():
    """The ``int`` path a batch decodes at one position: the same as
    the same position given as a tensor for every row."""
    cfg = registry.get(KIMI).reduced()
    params = model_zoo.init(cfg, 0, device=CPU)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)))
    tok = prompt[:, -1:]
    with torch.inference_mode():
        _, c1 = model_zoo.prefill(cfg, params, {"tokens": prompt}, 10)
        _, c2 = model_zoo.prefill(cfg, params, {"tokens": prompt}, 10)
        a, _ = model_zoo.decode_step(cfg, params, tok, c1, 6)
        b, _ = model_zoo.decode_step(cfg, params, tok, c2,
                                     torch.tensor([6, 6]))
    assert torch.equal(a, b)


def test_slot_step_is_one_batched_decode_step(lm):
    """``make_slot_step`` returns (S,) int32 tokens and writes the
    caches in place."""
    cfg, params, wl = lm
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    with lane_device(CPU):
        state = stepper.init_slots()
    step = make_slot_step(cfg)
    state["pos"][:] = PROMPT_LEN             # past the prefill's tokens
    # a token other than the slots' zero prompts: a recurrent layer's
    # conv window over a constant stream would shift to itself
    state["tokens"][:] = 1
    caches = state["caches"]
    before = [t.clone() for t in leaves(caches)]
    toks, out = step(params, state["tokens"], caches, state["pos"])
    assert out is caches and toks.shape == (stepper.n_slots,)
    assert toks.dtype == torch.int32
    # every layer's cache (K/V, MLA's latent ckv / kr, or a recurrent
    # layer's conv window and state) got its row
    assert all(not torch.equal(a, b) for a, b in zip(leaves(caches),
                                                     before))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
def test_engine_tokens_match_reference_generate():
    """The engine's tokens on parameters carried from the reference by
    ``from_jax`` equal the port's solo ``generate`` bitwise and the
    reference's ``generate`` (op by op, ``jax.disable_jit()``, its
    attention pinned to ``xla_ref``) up to a near tie: a token may
    differ only where the reference's top-1/top-2 gap is under the bf16
    model tolerance, and the row is compared no further."""
    jcfg = jax_registry.get(KIMI).reduced()
    cfg = registry.get(KIMI).reduced()
    jtree = jax_param.values(jax_zoo.init(jcfg, jax.random.key(0)))
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                             device="cpu", dtype=torch.bfloat16)
    wl = adapters.make_continuous_lm_adapter(
        cfg, tree, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
        name="serve-lm-cb/from-jax", warm_background=False)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, PROMPT_LEN)).astype(np.int32)
    try:
        sched = _sched()
        futs = [sched.submit(wl, {"prompt": prompts[b:b + 1]})
                for b in range(3)]
        out = torch.cat([f.result(timeout=300) for f in futs]).numpy()
        sched.shutdown()
    finally:
        adapters.unregister(wl)
    solo = generate(cfg, tree, torch.as_tensor(prompts).long(), NEW_TOKENS,
                    cache_len=CACHE_LEN).numpy()
    np.testing.assert_array_equal(out, solo)
    with ref_op_by_op():
        ref = np.asarray(jax_serve.generate(
            jcfg, jtree, jnp.asarray(prompts), NEW_TOKENS,
            cache_len=CACHE_LEN))
    if np.array_equal(out, ref):
        return
    # the reference's top-1/top-2 gaps along its own tokens
    with ref_op_by_op():
        lg, c = jax_zoo.prefill(jcfg, jtree, {"tokens": jnp.asarray(prompts)},
                                cache_len=CACHE_LEN)
        logits = [np.asarray(lg[:, -1], np.float32)]
        for t in range(NEW_TOKENS):
            lg, c = jax_zoo.decode_step(
                jcfg, jtree, jnp.asarray(ref[:, t:t + 1]), c,
                jnp.int32(PROMPT_LEN + t))
            logits.append(np.asarray(lg[:, 0], np.float32))
    top2 = np.sort(np.stack(logits, axis=1), axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    for b in range(3):
        for t in range(NEW_TOKENS + 1):
            if out[b, t] != ref[b, t]:
                assert gaps[b, t] < BF16_ATOL, (
                    f"row {b} token {t}: {out[b, t]} != {ref[b, t]}, the "
                    f"reference's top-1/top-2 gap {gaps[b, t]:.3f}")
                break


@pytest.mark.parametrize("n_params,prompt_len,n_steps",
                         [(1.0e6, 16, 1), (2.5e9, 1024, 17), (7, 0, 0)])
def test_lm_cost_terms_match_reference(n_params, prompt_len, n_steps):
    for mine, ref in (
            (cost_model.lm_prefill_terms(n_params, prompt_len),
             jax_cost_model.lm_prefill_terms(n_params, prompt_len)),
            (cost_model.lm_decode_terms(n_params, n_steps),
             jax_cost_model.lm_decode_terms(n_params, n_steps)),
            (cost_model.lm_decode_terms(n_params),
             jax_cost_model.lm_decode_terms(n_params))):
        assert repr(mine) == repr(ref)


def test_stepper_priors_match_the_reference_stepper(lm):
    """The LM stepper's prefill/decode priors are the reference's on
    the same parameter count."""
    _, params, wl = lm
    stepper = adapters.make_request(wl, {"batch": 1}).stepper
    assert repr(stepper.prefill_cost) == repr(
        jax_cost_model.lm_prefill_terms(stepper.n_params, PROMPT_LEN))
    assert repr(stepper.decode_cost) == repr(
        jax_cost_model.lm_decode_terms(stepper.n_params))


@pytest.mark.parametrize("wl,payload", [
    ("listrank", {"n": 1 << 10}), ("lbm", {"d": 8, "n_steps": 3}),
    ("dither", {"h": 32, "w": 48})])
def test_iter_steppers_match_the_reference_steppers(wl, payload):
    """Workload names, slot counts and priors of the iteration steppers
    are the reference's (dither's per-step prior divides by the port's
    wavefront steps, its quantum)."""
    from repro.workloads import requests as ref_adapters

    mine = adapters.make_request(wl, dict(payload, continuous=True)).stepper
    ref = ref_adapters.make_request(wl, dict(payload,
                                             continuous=True)).stepper
    assert mine.workload == ref.workload and mine.n_slots == ref.n_slots
    assert repr(mine.prefill_cost) == repr(ref.prefill_cost)
    if wl != "dither":
        assert repr(mine.decode_cost) == repr(ref.decode_cost)
    assert adapters.make_request(wl, payload).stepper is None


def test_engine_slots_knob(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_SLOTS", "8")
    assert adapters._engine_slots() == 8
    monkeypatch.setenv("REPRO_SERVE_SLOTS", "x")
    assert adapters._engine_slots() == 4


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_temperature_zero_is_the_greedy_path(lm):
    cfg, params, _ = lm
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, PROMPT_LEN)))
    greedy = generate(cfg, params, prompt, NEW_TOKENS)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(generate(cfg, params, prompt, NEW_TOKENS,
                                temperature=0.0, generator=gen), greedy)
    lg = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
    assert torch.equal(sample_tokens(lg, 0.0, gen), lg.argmax(-1))
    step = make_serve_step(cfg, temperature=0.0)
    with torch.inference_mode():
        _, c = model_zoo.prefill(cfg, params, {"tokens": prompt}, 12)
        tok, _ = step(params, prompt[:, -1:], c, PROMPT_LEN, gen)
        _, c = model_zoo.prefill(cfg, params, {"tokens": prompt}, 12)
        want, _ = make_serve_step(cfg)(params, prompt[:, -1:], c, PROMPT_LEN)
    assert torch.equal(tok, want)


def test_sampled_generate_is_reproducible(lm):
    cfg, params, _ = lm
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT_LEN)))

    def run(seed):
        return generate(cfg, params, prompt, NEW_TOKENS, temperature=1.5,
                        generator=torch.Generator().manual_seed(seed))

    a, b = run(7), run(7)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert a.shape == (2, NEW_TOKENS + 1)
    greedy = generate(cfg, params, prompt, NEW_TOKENS)
    assert torch.equal(a[:, 0], greedy[:, 0])     # the prefill's argmax
    assert not all(torch.equal(run(s), greedy) for s in range(4))


@pytest.mark.parametrize("temperature", [0.7, 2.0])
def test_sampling_draws_from_softmax_of_scaled_logits(temperature):
    """The per-token log-probabilities of the draws are
    ``log_softmax(logits / T)``, as the reference's ``categorical``
    draws them: the port's and the reference's draw frequencies both
    match it."""
    V, n = 6, 40000
    logits = np.array([[1.0, 0.2, -0.5, 2.0, 0.0, -3.0]], np.float32)
    logp = torch.log_softmax(torch.as_tensor(logits) / temperature, -1)[0]
    jlogp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits) / temperature,
                                          axis=-1))[0]
    np.testing.assert_allclose(logp.numpy(), jlogp, rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(torch.as_tensor(logits).expand(n, V).contiguous(),
                          temperature, gen)
    jdraws = np.asarray(jax.random.categorical(
        jax.random.key(0), jnp.asarray(logits) / temperature,
        shape=(n, 1)))[:, 0]
    p = np.exp(jlogp)
    sigma = np.sqrt(p * (1 - p) / n)
    for d in (draws.numpy(), jdraws):
        freq = np.bincount(d, minlength=V) / n
        assert np.all(np.abs(freq - p) < 5 * sigma + 1e-9), (freq, p)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_continuous_stream_on_the_cpu_pair(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", KIMI, "--batch", "1", "--prompt-len", "8",
            "--new-tokens", "3"]
    solo = serve.main(argv, device="cpu")
    out = serve.main(argv + ["--stream", "--continuous", "--rate", "20",
                             "--duration", "0.3"], device="cpu")
    text = capsys.readouterr().out
    assert out["rejected"] == 0 and out["tokens"]
    assert all(torch.equal(t, solo) for t in out["tokens"])
    st = out["stats"]
    assert st.engine_steps > 0 and st.in_flight == 0
    assert st.engine_joins == len(out["tokens"]) + 1
    (name, plan), = out["engine_placements"].items()
    assert f"engine {name}: prefill={plan.prefill_group} " \
           f"decode={plan.decode_group}" in text
    assert len(out["ttft_s"]) == len(out["tokens"])
    adapters.unregister(out["workload"])


def test_precompile_merged_runs_steppers_and_merges_on_each_device():
    """The registry-level warm-up: a stepper's programs and the merged
    stacks run once ahead of traffic on every listed device, in the
    background on a ``precompile-*`` thread, and ``wait_precompiled``
    meets it."""
    mix = [("hist", {"n": 1 << 10, "n_bins": 16}),
           ("listrank", {"n": 1 << 8, "seed": 1, "continuous": True})]
    stepper = adapters.make_request(*mix[1]).stepper
    calls = []
    warm = stepper.warm

    def spy():
        calls.append(str(current_device()))
        warm()

    stepper.warm = spy
    try:
        adapters.precompile_merged(mix, max_batch=2, background=True,
                                   devices=["cpu"])
        assert [t for t in threading.enumerate()
                if t.name == "precompile-merged"] or calls
        assert adapters.wait_precompiled(timeout=120)
    finally:
        del stepper.warm
    assert calls == ["cpu"]
