"""The port's bench scripts (``repro_torch.benchmarks``: ``regress``,
``serving_bench``, ``kernels_bench``, ``run`` and the scenario runner)
on the CPU.

``regress.check`` is held against the reference's
(``benchmarks/regress.py``, which imports no JAX) on synthetic
histories: every verdict and every line equal.  ``serving_bench``'s
trace generator equals the reference's for three seeds; its scheduler,
two-process and fleet sections run at tiny sizes on the CPU's simulated
pair (``device="cpu"``).  ``kernels_bench`` and ``run`` write only
where they are told (``tmp_path``), never the repository's ``BENCH_*``
files.
"""
import importlib.util
import json
import os
import tempfile

import pytest

from repro_torch.benchmarks import kernels_bench, regress, run as run_mod
from repro_torch.benchmarks import serving_bench
from repro_torch.benchmarks.scenarios import run_scenarios
from repro_torch.core.calibration import clear_calibration_cache
from repro_torch.serve import router as router_mod
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.scenario import build_trace, load_spec, trace_digest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_ref(name):
    """A reference script under ``benchmarks/``, by path (the directory
    is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(_ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_regress = _load_ref("regress")


@pytest.fixture(autouse=True)
def _fresh_state():
    clear_calibration_cache()
    yield
    router_mod.shutdown_all(timeout=10.0)
    sched_mod.shutdown_all(timeout=10.0)
    clear_calibration_cache()


# ---------------------------------------------------------------------------
# regress.check against the reference's
# ---------------------------------------------------------------------------
def _rows(*entries, backend="torch:cuda"):
    return [{"ts": f"t{i}", "backend": backend, "name": n, "us": us}
            for i, (n, us) in enumerate(entries)]


HISTORIES = {
    "pass": _rows(("kernels/hist_1M", 1000.0), ("kernels/hist_1M", 1100.0)),
    "kernel_regression": _rows(("kernels/conv_512", 1000.0),
                               ("kernels/conv_512", 1300.0)),
    "kernel_under_min_delta": _rows(("kernels/spmv_4k", 50.0),
                                    ("kernels/spmv_4k", 120.0)),
    "cold_within": _rows(("cold_start/conv2d_topk", 100_000.0),
                         ("cold_start/conv2d_topk", 170_000.0)),
    "cold_regression": _rows(("cold_start/conv2d_topk", 100_000.0),
                             ("cold_start/conv2d_topk", 190_000.0)),
    "serving_within": _rows(("serving/p95_sched_x2.5_m2", 100_000.0),
                            ("serving/p95_sched_x2.5_m2", 150_000.0)),
    "serving_regression": _rows(("serving/p95_sched_x2.5_m2", 100_000.0),
                                ("serving/p95_sched_x2.5_m2", 170_000.0)),
    "serving_under_min_delta": _rows(("serving/tput_sched_x0.5_m2", 10_000.0),
                                     ("serving/tput_sched_x0.5_m2", 25_000.0)),
    "informational": _rows(("serving/p95_ratio_at_max_m2", 1e6),
                           ("serving/p95_ratio_at_max_m2", 9e6),
                           ("serving/p95_fifo_x2.5_m2", 1e5),
                           ("serving/p95_fifo_x2.5_m2", 9e5),
                           ("serving/fleet_cold_probe_ft1", 0.0),
                           ("serving/fleet_cold_probe_ft1", 3.0),
                           ("serving/scenario_info_flash_crowd_s1", 1.0),
                           ("serving/scenario_info_flash_crowd_s1", 9.0)),
    "first_seen": _rows(("kernels/gmm_8x256", 500.0),
                        ("kernels/sort_256x1k", 900.0),
                        ("kernels/sort_256x1k", 905.0)),
    "per_backend": (_rows(("kernels/hist_1M", 1000.0))
                    + _rows(("kernels/hist_1M", 5000.0),
                            backend="torch:cpu")),
}


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_regress_check_equals_the_reference(case):
    rows = HISTORIES[case]
    ours = regress.check(rows, 0.2)
    ref = ref_regress.check(rows, 0.2)
    assert ours == ref
    failures, lines = ours
    want_fail = case.endswith("_regression")
    assert bool(failures) == want_fail, lines
    if case == "first_seen":
        assert any("first entry" in ln for ln in lines)
    if case == "per_backend":
        assert sorted({ln.split("]")[0] for ln in lines}) == \
            ["[torch:cpu", "[torch:cuda"]


def test_regress_main_reads_its_history(tmp_path, capsys):
    path = tmp_path / "hist.jsonl"
    assert regress.main(["--history", str(path)]) == 0   # no file: pass
    with open(path, "w") as f:
        for row in HISTORIES["kernel_regression"]:
            f.write(json.dumps(row) + "\n")
        f.write("not json\n")
    assert regress.main(["--history", str(path)]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert regress.main(["--history", str(path), "--threshold", "0.5"]) == 0
    assert regress.HISTORY == "BENCH_torch_history.jsonl"


# ---------------------------------------------------------------------------
# serving_bench
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 29])
def test_make_trace_equals_the_reference(seed):
    ref_sb = _load_ref("serving_bench")
    for smoke in (True, False):
        mix = serving_bench._mix(smoke)
        assert mix == ref_sb._mix(smoke)
        assert serving_bench._mix13(smoke) == ref_sb._mix13(smoke)
        ours = serving_bench.make_trace(40.0, 30, mix, seed=seed)
        ref = ref_sb.make_trace(40.0, 30, mix, seed=seed)
        assert ours == ref
        assert serving_bench.make_trace(9.0, 26, mix, seed=seed,
                                        cycle=True) == \
            ref_sb.make_trace(9.0, 26, mix, seed=seed, cycle=True)


def test_drive_keeps_the_accounting_invariant_on_the_cpu():
    mix = [("hist", {"n": 1 << 12, "n_bins": 32}),
           ("conv", {"size": 64, "ksize": 5})]
    trace = serving_bench.make_trace(200.0, 12, mix, seed=3)
    for policy in ("cost", "fifo"):
        m = serving_bench.drive(policy, trace, max_batch=1,
                                result_timeout_s=60, device="cpu")
        assert m["dropped_without_rejection"] == 0
        assert m["served"] == 12 and m["hung"] == 0
        assert m["p99_ms"] >= m["p95_ms"] >= m["p50_ms"] > 0


def test_two_process_check_plans_the_cold_process_with_zero_probes():
    # A's own placements may legitimately probe nothing (an
    # all-dedicated run); the gate is B's zero, as the bench's
    _, b = serving_bench.two_process_check(verbose=False, device="cpu")
    assert b == 0


def test_fleet_cold_join_places_off_the_shared_store(tmp_path):
    mix = [("hist", {"n": 1 << 12, "n_bins": 32})]
    _, b = serving_bench.fleet_cold_join_check(mix, verbose=False,
                                               device="cpu",
                                               root=str(tmp_path))
    assert b == 0


def test_fleet_and_child_stores_are_removed_after_use(tmp_path,
                                                    monkeypatch):
    """The cold-join check's throwaway stores (under ``root``) and the
    two-process check's (under the temporary directory) are removed
    once their workers have exited: nothing new is left in either."""
    tmp_root = tmp_path / "tmp"
    tmp_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_root))
    fleet_root = tmp_path / "fleet"
    fleet_root.mkdir()
    mix = [("hist", {"n": 1 << 12, "n_bins": 32})]
    serving_bench.fleet_cold_join_check(mix, verbose=False, device="cpu",
                                        root=str(fleet_root))
    assert os.listdir(fleet_root) == []
    serving_bench.two_process_check(verbose=False, device="cpu")
    assert [n for n in os.listdir(tmp_root) if n.startswith("repro-")] == []


def test_meta_names_the_framework_and_device():
    assert serving_bench.meta("cpu") == {"framework": "torch",
                                         "device": "cpu", "smoke": False}


# ---------------------------------------------------------------------------
# the scenario runner, kernels_bench and run
# ---------------------------------------------------------------------------
def test_scenario_runner_replays_heavy_tail_on_the_cpu(capsys):
    """``run_scenarios --smoke --only heavy_tail --device cpu``: the
    port's runner on the simulated pair, its rows and exit status."""
    assert run_scenarios.main(["--smoke", "--only", "heavy_tail",
                               "--device", "cpu"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("serving/scenario_")]
    names = [r.split(",")[0] for r in rows]
    assert "serving/scenario_heavy_tail_goodput_s1" in names
    assert "serving/scenario_info_heavy_tail_s1" in names
    assert any(n.startswith("serving/scenario_heavy_tail_p95_")
               for n in names)
    info = [r for r in rows if "scenario_info_" in r][0]
    assert "dropped=0" in info
    spec = load_spec(os.path.join(run_scenarios._HERE, "heavy_tail.json"))
    assert f"digest={trace_digest(build_trace(spec, scale=0.4))[:12]}" \
        in info


def _repo_files():
    return {fn: os.stat(os.path.join(_ROOT, fn)).st_mtime_ns
            for fn in os.listdir(_ROOT)
            if os.path.isfile(os.path.join(_ROOT, fn))}


def test_kernels_bench_on_the_cpu():
    rows = kernels_bench.run(device="cpu")
    names = [r.split(",")[0] for r in rows]
    assert names == ["kernels/hist_1M", "kernels/attn_1k",
                     "kernels/gmm_8x256", "kernels/conv_512",
                     "kernels/spmv_4k", "kernels/sort_256x1k"]
    for r in rows:
        assert "|cfg=impl=" in r and "|vs_default=" in r


def test_run_writes_only_into_its_out_dir(tmp_path, monkeypatch):
    # two cheap sections, and none of the sections that spawn
    # subprocesses (cold start, serving)
    monkeypatch.setattr(run_mod, "SECTIONS", {
        k: run_mod.SECTIONS[k] for k in ("fig5", "kernels")})
    monkeypatch.setattr(run_mod, "JSON_SECTIONS", {})
    before = _repo_files()
    out = tmp_path / "bench"
    assert run_mod.main(["--json", "--out", str(out)], device="cpu") == 0
    assert sorted(os.listdir(out)) == ["BENCH_torch_history.jsonl",
                                       "BENCH_torch_hybrid.json",
                                       "BENCH_torch_kernels.json"]
    with open(out / "BENCH_torch_kernels.json") as f:
        doc = json.load(f)
    assert doc["meta"] == {"framework": "torch", "device": "cpu"}
    assert len(doc["rows"]) == 6
    with open(out / "BENCH_torch_hybrid.json") as f:
        assert any(r["name"].startswith("fig5/")
                   for r in json.load(f)["rows"])
    with open(out / "BENCH_torch_history.jsonl") as f:
        hist = [json.loads(ln) for ln in f]
    assert {h["backend"] for h in hist} == {"torch:cpu"}
    assert len(hist) == 6
    assert regress.main(["--history",
                         str(out / "BENCH_torch_history.jsonl")]) == 0
    assert _repo_files() == before
