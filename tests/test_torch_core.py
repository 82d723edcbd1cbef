"""The port's core (``repro_torch.core``, ``repro_torch.obs``) against
the JAX reference's, on the CPU.

Planning, chunking and stealing are pure decisions: the same inputs
must give the same outputs as the reference, exactly.  Timing and the
hardware profile can only be checked for sign and shape here.
"""
import json
import os
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import async_executor as ref_async
from repro.core import metrics as ref_metrics
from repro.core import work_sharing as ref_ws
from repro.core.hybrid_executor import DeviceGroup as RefGroup
from repro_torch.core import async_executor, cost_model, metrics
from repro_torch.core import work_sharing as ws
from repro_torch.core.calibration import (CalibrationCache,
                                          get_calibration_cache, measure)
from repro_torch.core.hybrid_executor import (DeviceGroup, HybridExecutor,
                                              detect_platform)
from repro_torch.obs import get_recorder

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_cases(seed, n=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        groups = int(rng.integers(1, 4))
        thr = [float(t) for t in rng.uniform(0.0, 10.0, groups)]
        if all(t == 0 for t in thr):
            thr[0] = 1.0
        yield (int(rng.integers(1, 500)), thr, float(rng.uniform(0, 1)),
               int(rng.integers(0, 5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_work_and_integer_shares_match_reference(seed):
    for total, thr, comm, min_units in _random_cases(seed):
        assert ws.integer_shares(total, thr, min_units) == \
            ref_ws.integer_shares(total, thr, min_units)
        assert asdict(ws.plan_work(total, thr, comm, 0.1, min_units)) == \
            asdict(ref_ws.plan_work(total, thr, comm, 0.1, min_units))
        assert ws.refine_split(total, [1.0] * len(thr), [1] * len(thr)) \
            == ref_ws.refine_split(total, [1.0] * len(thr), [1] * len(thr))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_chunks_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        units = [int(u) for u in rng.integers(0, 60, 3)]
        if not sum(units):
            units[0] = 1
        names = ["a", "b", "c"]
        cu = int(rng.integers(1, 9))
        mine = async_executor.make_chunks(units, names, cu)
        ref = ref_async.make_chunks(units, names, cu)
        assert {n: [tuple(vars(c).values()) for c in q]
                for n, q in mine.items()} == \
            {n: [tuple(vars(c).values()) for c in q] for n, q in ref.items()}
        mine = async_executor.make_share_chunks(units, names)
        ref = ref_async.make_share_chunks(units, names)
        assert {n: [tuple(vars(c).values()) for c in q]
                for n, q in mine.items()} == \
            {n: [tuple(vars(c).values()) for c in q] for n, q in ref.items()}


def _schedule(mod, group_cls, units, rates, steal):
    ex = mod.AsyncChunkExecutor(
        [group_cls("accel", [], "accel"), group_cls("host", [], "host")],
        steal=steal, time_model=lambda g, k: k * rates[g])
    trace = ex.run(units, lambda g, s, k: (g, s, k), chunk_units=2,
                   mode="virtual", unit_time_priors={"accel": 1.0,
                                                     "host": 1.0})
    return ([(r.chunk.seq, r.group, r.stolen, round(r.t_start, 9))
             for r in trace.records], trace.steals, trace.makespan,
            trace.outputs)


@pytest.mark.parametrize("units,rates,steal", [
    ([10, 10], {"accel": 1.0, "host": 4.0}, True),      # mis-planned
    ([16, 4], {"accel": 1.0, "host": 4.0}, True),       # balanced
    ([4, 16], {"accel": 1.0, "host": 1.0}, True),
    ([10, 10], {"accel": 1.0, "host": 4.0}, False),
])
def test_steal_decisions_match_reference(units, rates, steal):
    """The virtual-clock schedule — which chunk runs where, which are
    stolen, when — is the reference's, chunk for chunk."""
    mine = _schedule(async_executor, DeviceGroup, units, rates, steal)
    ref = _schedule(ref_async, RefGroup, units, rates, steal)
    assert mine == ref
    if steal and units == [10, 10] and rates["host"] > rates["accel"]:
        assert mine[1] > 0                    # the fast group stole


def test_threads_mode_runs_each_chunk_once():
    seen = []

    def run_chunk(g, s, k):
        seen.append((s, k))
        return (s, k)

    ex = async_executor.AsyncChunkExecutor(
        [DeviceGroup("accel", [torch.device("cpu")], "accel"),
         DeviceGroup("host", [torch.device("cpu")], "host")])
    trace = ex.run([12, 4], run_chunk, chunk_units=2, mode="threads")
    assert sorted(seen) == sorted(trace.outputs)
    assert sorted(s for s, _ in seen) == list(range(0, 16, 2))
    assert trace.mode == "threads" and trace.n_chunks == 8


def test_measure_returns_positive_times():
    x = torch.ones(1 << 16)
    for reduce in ("mean", "min"):
        t = measure(lambda: x * 2.0, warmup=1, iters=3, reduce=reduce)
        assert t > 0.0
    assert measure(lambda: x * 2.0, warmup=0, iters=0) > 0.0


def test_hybrid_result_metrics_match_reference():
    args = ("conv", 1.5, {"accel": 2.0, "host": 6.0},
            {"accel": 1.4, "host": 1.2})
    kw = dict(analytic_time=1.4, steals=2, n_chunks=16, mode="virtual",
              analytic_observed_time=1.45)
    mine, ref = metrics.HybridResult(*args, **kw), \
        ref_metrics.HybridResult(*args, **kw)
    for attr in ("gain", "idle_fracs", "resource_efficiency",
                 "model_agreement", "overlap_agreement", "best_single"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.row() == ref.row()


def test_detect_platform():
    groups, sim = detect_platform(device="cpu", simulated_ratio=3.0)
    assert sim and [g.slowdown for g in groups] == [1.0, 3.0]
    assert [str(g.devices[0]) for g in groups] == ["cpu", "cpu"]
    if torch.cuda.is_available():
        groups, sim = detect_platform()
        assert not sim
        assert [str(g.devices[0]) for g in groups] == ["cuda:0", "cpu"]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            detect_platform()
        with pytest.raises(RuntimeError, match="CUDA"):
            HybridExecutor()


def test_calibration_store_keys_carry_the_framework(tmp_path, monkeypatch):
    """Unit times persist under ``torch:cpu``, never under a JAX backend
    name, so they cannot feed the reference's planner."""
    from repro.core.calibration import CalibrationCache as RefCache
    path = str(tmp_path / "calib.json")
    CalibrationCache(path=path, backend="torch:cpu").put("w", "accel", 0.5)
    with open(path) as f:
        assert list(json.load(f)["unit_times"]) == ["torch:cpu"]
    assert RefCache(path=path).get("w", "accel") is None
    monkeypatch.setenv("REPRO_CALIB_CACHE", path)
    assert get_calibration_cache("torch:cuda") is not \
        get_calibration_cache("torch:cpu")
    assert get_calibration_cache("torch:cpu").get("w", "accel") == 0.5


def test_cost_model_profiles_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "c.json"))
    cost_model.reset_profiles()
    try:
        p = cost_model.get_profile("cpu")
        assert p.backend == "torch:cpu" and p.measured
        assert p.interpret_step_s == 0.0
        assert min(p.matmul_flops, p.ew_flops, p.mem_bw, p.dispatch_s,
                   p.host_bw) > 0
        with open(tmp_path / "c.json") as f:
            assert "torch:cpu" in json.load(f)["hardware"]
        monkeypatch.setenv("REPRO_COST_MODEL", "0")
        for dev in ("cpu", "cuda"):
            s = cost_model.get_profile(dev)
            assert not s.measured and s.backend == f"torch:{dev}"
    finally:
        cost_model.reset_profiles()


def test_executor_traces_chunks():
    rec = get_recorder()
    rec.clear()
    ex = HybridExecutor(device="cpu", n_chunks=4)
    ex.run_work_shared("t", 8, lambda g, s, k: torch.zeros(k),
                       combine=lambda outs: torch.cat(outs))
    spans = [e for e in rec.events() if e["name"] == "chunk"]
    assert sum(e["args"]["units"] for e in spans) == 8
    assert {e["track"] for e in spans} <= {"hybrid:accel", "hybrid:host"}


def test_plan_override_must_cover_the_work():
    ex = HybridExecutor(device="cpu", n_chunks=4)
    with pytest.raises(ValueError, match="cover"):
        ex.run_work_shared("t", 8, lambda g, s, k: torch.zeros(k),
                           combine=lambda outs: torch.cat(outs),
                           plan_override=[4, 2])


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports in a fresh interpreter without
    pulling in JAX or the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert len(mods) >= 20, mods\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
