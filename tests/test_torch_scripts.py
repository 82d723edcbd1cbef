"""The port's scripts and the executor hooks they read, on the CPU:
``HybridExecutor.last_probe_runs`` against the
reference's executor, ``benchmarks.fig5_tasks``, ``examples.quickstart``
(``device="cpu"``, tiny sizes), ``benchmarks.overlap_check`` and
``benchmarks.cold_start``'s child helpers run in-process (the scripts
themselves spawn them as subprocesses and run on the GPU)."""
import json

import numpy as np
import pytest
import torch

from repro.core.hybrid_executor import HybridExecutor as RefExecutor
from repro.core.task_graph import TaskGraph as RefTaskGraph
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref
from repro_torch.benchmarks import cold_start, fig5_tasks, overlap_check
from repro_torch.core import calibration
from repro_torch.core.hybrid_executor import HybridExecutor
from repro_torch.examples import quickstart
from repro_torch.kernels import autotune as at
from repro_torch.workloads import conv, listrank


# ------------------------------------------- calibrate's probe count
def test_calibrate_last_probe_runs_matches_reference():
    """A cold calibration runs each group's probe twice (a warmup and
    one timed run) and reports the groups that probed; a warm one
    probes nothing — the reference's counts, on the simulated pair."""
    counts = {}
    for name, ex in (("ref", RefExecutor(simulated_ratio=4.0)),
                     ("port", HybridExecutor(simulated_ratio=4.0,
                                             device="cpu"))):
        calls = []
        wl = f"probe-{name}"
        ex.calibrate(lambda g, n: calls.append(g), probe_units=4,
                     workload=wl)
        cold = (len(calls), ex.last_probe_runs)
        calls.clear()
        ex.calibrate(lambda g, n: calls.append(g), probe_units=4,
                     workload=wl)
        counts[name] = (cold, (len(calls), ex.last_probe_runs))
    assert counts["port"] == counts["ref"] == ((4, 2), (0, 0))


def test_calibrate_model_prior_probes_nothing():
    from repro_torch.core.cost_model import CostTerms
    ex = HybridExecutor(device="cpu")
    calls = []
    ex.calibrate(lambda g, n: calls.append(g), probe_units=4,
                 workload="probe-model",
                 unit_cost=CostTerms(flops=1e6, bytes=1e6))
    assert calls == [] and ex.last_probe_runs == 0


# ------------------------------------------------------------ fig5
def test_fig5_tasks_row(capsys):
    n = 1 << 10
    out = fig5_tasks.run(n=n, device="cpu")
    text = capsys.readouterr().out
    assert text.startswith("fig5/LR,") and "paper=57.7%@HybridHigh" in text
    assert "accel  busy" in text and "host   busy" in text
    assert out.simulated and out.result.hybrid_time > 0
    # the ranks walk the list: the head is n - 1 from the tail
    succ, head = listrank.make_list(n)
    rank = out.value.cpu().numpy()
    node, want = head, n - 1
    while succ[node] != node:
        assert rank[node] == want
        node, want = succ[node], want - 1
    assert rank[node] == 0


# ------------------------------------------------------- quickstart
def test_quickstart_on_the_cpu(capsys):
    out = quickstart.main(device="cpu", size=64, ksize=5, seq=16)
    text = capsys.readouterr().out
    for head in ("work plan:", "schedule makespan:", "hybrid conv:",
                 "tiny LM logits:"):
        assert head in text
    assert list(out["plan"].units) == [80, 20]
    # §2: the reference's schedule of the same graph ("tpu" there)
    ref = (RefTaskGraph()
           .add("prng", {"cpu": 0.5, "tpu": 2.0}, output_bytes=512e6)
           .add("fis", {"tpu": 0.6}, deps=["prng"])
           .add("rank", {"tpu": 1.0, "cpu": 8.0}, deps=["fis"])
           .schedule({"cpu0": "cpu", "tpu0": "tpu"}))
    assert out["schedule"].makespan == pytest.approx(ref.makespan)
    assert out["schedule"].critical_path == ref.critical_path
    # §3: the conv value against the reference's oracle
    img, w = conv.make_inputs(64, 5)
    np.testing.assert_allclose(
        out["hybrid"].value.numpy(),
        np.asarray(jax_conv_ref(img, w)), rtol=2e-4, atol=2e-4)
    # §4
    assert tuple(out["logits"].shape) == (2, 16, 512)
    assert bool(torch.isfinite(out["logits"].float()).all())


def test_quickstart_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main()


# ---------------------------------------------------- overlap_check
def test_overlap_check_on_the_simulated_pair(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    at.reset_tune_cache()
    try:
        r = overlap_check.run(size=64, ksize=5, device="cpu")
    finally:
        at.reset_tune_cache()
    assert r["mode"] == "virtual" and r["n_devices"] == 1
    assert 2 <= r["n_chunks"] <= 32 and r["floor"] > 0
    assert sum(r["split"].values()) == 64
    for key in ("legacy3x_wall", "seq1x_wall", "async_wall"):
        assert r[key] > 0


# ---------------------------------------- cold_start's child helpers
TINY = {
    "conv2d": {"n": 32, "neighbor": 48, "K": 5},
    "hist": {"n": 4096, "neighbor": 2048, "bins": 16},
    "flash_attention": {"T": 32, "neighbor": 16, "H": 4, "Kv": 2, "d": 16},
    "gmm": {"C": 8, "neighbor": 16, "E": 2, "D": 16, "F": 8},
}


# a config the full search's winner is timed against when they differ
RIVAL = {"conv2d": {"impl": "torch_shift"}, "hist": {"impl": "torch_sort"},
         "flash_attention": {"impl": "torch_ref"},
         "gmm": {"impl": "torch_einsum"}}


@pytest.fixture
def child_env(monkeypatch, tmp_path):
    """The children set the tune and store knobs in os.environ; record
    them here so that they are restored, and give them tiny shapes."""
    for k in ("REPRO_AUTOTUNE", "REPRO_TUNE_CACHE", "REPRO_TUNE_TOPK",
              "REPRO_TUNE_TRANSFER", "REPRO_COST_MODEL",
              "REPRO_CALIB_CACHE"):
        monkeypatch.setenv(k, "")
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))
    monkeypatch.setattr(cold_start, "SHAPES", TINY)
    at.reset_tune_cache()
    yield tmp_path
    at.reset_tune_cache()


@pytest.mark.parametrize("kernel", cold_start.KERNELS)
def test_cold_start_search_children(child_env, kernel):
    assert cold_start.child_profile("cpu") == {"ok": True}
    d = child_env / kernel
    d.mkdir()
    topk = cold_start.child_search(kernel, str(d), "topk", device="cpu")
    assert 1 <= topk["n_measured"] <= topk["n_candidates"]
    assert topk["n_warm"] == 0            # the second lookup measures 0
    assert topk["n_transfer"] == 1        # the neighbour: one measurement
    assert topk["cfg_transfer"] == topk["cfg"]
    rival = json.dumps(RIVAL[kernel])
    full = cold_start.child_search(kernel, str(d), "full", device="cpu",
                                   rival_cfg=rival)
    assert full["n_measured"] == full["n_candidates"]
    if full["cfg"] != RIVAL[kernel]:
        assert full["winner_time_ratio"] > 0
    assert (d / "topk.json").exists() and (d / "full.json").exists()


def test_cold_start_hybrid_children(child_env, monkeypatch):
    """Process A probes cold and persists; a later first call on the
    same stores (the in-memory caches dropped, as in a new process)
    probes nothing and plans exactly the split A would plan next from
    what it persisted."""
    a = cold_start.child_hybrid(1, str(child_env), device="cpu", size=64,
                                ksize=5)
    monkeypatch.setattr(calibration, "_GLOBAL_CACHE_PATH", None)
    b = cold_start.child_hybrid(2, str(child_env), device="cpu", size=64,
                                ksize=5)
    assert a["probes_first_call"] == 2 and b["probes_first_call"] == 0
    assert a["simulated"] and a["chunk_units"] == 4
    assert sum(a["plan"].values()) == sum(b["plan"].values()) == 64
    assert b["plan"] == a["next_plan"]
