"""The port's examples (``repro_torch.examples.hybrid_workloads``,
``serve_lm``) and what they bring with them (``core.metrics.summarize``,
``HybridExecutor(steal=)``), on the CPU, against the reference's.

``summarize`` over the same ``HybridResult`` fields prints the
reference's string; ``hybrid_workloads`` keeps the reference's flags and
``QUICK`` sizes and runs on the simulated pair on the CPU (with and
without work stealing; the steal-off run records no steal);
``serve_lm`` runs greedy ``generate`` on the tiny dense config and on a
``reduced()`` arch.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.core.metrics import HybridResult as RefHybridResult
from repro.core.metrics import summarize as ref_summarize
from repro_torch.core import HybridExecutor, summarize
from repro_torch.core.calibration import clear_calibration_cache
from repro_torch.core.hybrid_executor import DeviceGroup
from repro_torch.core.metrics import HybridResult
from repro_torch.examples import hybrid_workloads, serve_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_calibration():
    clear_calibration_cache()
    yield
    clear_calibration_cache()


def _reference_example():
    """The reference's ``examples/hybrid_workloads.py`` as a module (it
    is a script, not a package member)."""
    path = os.path.join(ROOT, "examples", "hybrid_workloads.py")
    spec = importlib.util.spec_from_file_location("ref_hybrid_workloads",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RESULT_FIELDS = [
    dict(workload="conv", hybrid_time=0.0123, single_times={
        "accel": 0.015, "host": 0.06}, busy_times={"accel": 0.012,
                                                   "host": 0.011},
         analytic_time=0.0119, steals=3, n_chunks=16, mode="threads"),
    dict(workload="hist", hybrid_time=0.004, single_times={
        "accel": 0.0035, "host": 0.02}, busy_times={"accel": 0.003,
                                                    "host": 0.001}),
    dict(workload="Dither", hybrid_time=1.5, single_times={
        "accel": 1.5, "host": 6.0}, busy_times={"accel": 1.2,
                                                "host": 0.4},
         analytic_time=1.4, mode="virtual"),
]


@pytest.mark.parametrize("n", [0, 1, 3])
def test_summarize_matches_reference(n):
    mine = [HybridResult(**f) for f in RESULT_FIELDS[:n]]
    ref = [RefHybridResult(**f) for f in RESULT_FIELDS[:n]]
    assert summarize(mine) == ref_summarize(ref)
    if n:
        assert summarize(mine).splitlines()[-1].startswith("MEAN")


def test_hybrid_workloads_keeps_the_references_sizes_and_flags():
    ref = _reference_example()
    assert hybrid_workloads.QUICK == ref.QUICK
    with pytest.raises(SystemExit):
        hybrid_workloads.main(["--bogus"], device="cpu")


@pytest.mark.parametrize("steal", [True, False])
def test_hybrid_workloads_runs_on_the_cpu(capsys, steal):
    argv = ["--only", "hist", "--repeat", "1", "--chunks", "8"]
    if not steal:
        argv.append("--no-steal")
    results = hybrid_workloads.main(argv, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("pair: simulated on cpu at ratio 3.9 "
                      "(accel=cpu + host=cpu)")
    assert len(results) == 1 and results[0].workload.lower() == "hist"
    assert results[0].n_chunks == 8
    assert out[-1].startswith("MEAN")
    assert "\n".join(out[-2:]) == summarize(results)
    if not steal:
        assert results[0].steals == 0


def test_hybrid_workloads_names_the_real_pair_on_a_gpu(capsys, monkeypatch):
    """On a GPU host the example runs the real pair and says that
    ``--ratio`` does not apply (the groups faked here: no GPU on this
    box, so no workload runs)."""
    groups = [DeviceGroup("accel", [torch.device("cuda", 0)], "accel"),
              DeviceGroup("host", [CPU], "host")]
    monkeypatch.setattr(hybrid_workloads, "detect_platform",
                        lambda ratio, device: (groups, False))
    monkeypatch.setattr(hybrid_workloads, "ALL_WORKLOADS", ())
    hybrid_workloads.main(["--ratio", "10"])
    first = capsys.readouterr().out.splitlines()[0]
    assert first == ("pair: real (accel=cuda:0 + host=cpu); --ratio does "
                     "not apply")


@pytest.mark.parametrize("steal,override,want", [
    (True, None, True), (False, None, False), (True, [32, 32], False)])
def test_executor_steal_flag_turns_stealing_off(monkeypatch, steal,
                                                override, want):
    """``HybridExecutor(steal=False)`` hands the chunk executor no
    stealing, whatever the call; a plan override never steals; the
    default steals."""
    from repro_torch.core import hybrid_executor as hx

    seen = []
    real = hx.AsyncChunkExecutor

    def spy(groups, steal=True, **kw):
        seen.append(steal)
        return real(groups, steal=steal, **kw)

    monkeypatch.setattr(hx, "AsyncChunkExecutor", spy)
    groups = [DeviceGroup("accel", [CPU], "accel"),
              DeviceGroup("host", [CPU], "host", slowdown=4.0)]
    assert HybridExecutor(groups=groups).steal is True
    ex = HybridExecutor(groups=groups, n_chunks=8, steal=steal)

    def share(g, start, k):
        return list(range(start, start + k))

    ex.calibrate(lambda g, k: share(g, 0, k), probe_units=4,
                 workload="steal-test")
    out = ex.run_work_shared("steal-test", 64, share,
                             lambda outs: [x for o in outs for x in o],
                             plan_override=override)
    assert out.value == list(range(64))
    assert seen == [want]
    if not want:
        assert out.result.steals == 0


def test_serve_lm_example_runs_on_the_cpu(capsys):
    out = serve_lm.main(["--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "4"], device="cpu")
    assert out.shape == (2, 5) and out.dtype == torch.int32
    text = capsys.readouterr().out
    assert text.startswith("serving lm-tiny: 4L d=256 on cpu")
    red = serve_lm.main(["--arch", "kimi-k2-1t-a32b", "--batch", "2",
                         "--prompt-len", "8", "--new-tokens", "4"],
                        device="cpu")
    assert red.shape == (2, 5)
    assert int(red.min()) >= 0
    np.testing.assert_array_equal(
        red.numpy(), serve_lm.main(["--arch", "kimi-k2-1t-a32b", "--batch",
                                    "2", "--prompt-len", "8",
                                    "--new-tokens", "4"],
                                   device="cpu").numpy())


def test_serve_lm_example_needs_a_gpu_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the example would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main([])
