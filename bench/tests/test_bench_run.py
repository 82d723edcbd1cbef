"""A cell's whole run on the CPU at a reduced size (``cpu_cell``): a sound
run is correct, every fault planted in the timed path turns ``correct``
false, the fp8 control's gaps lie past the limit a sound run keeps
under, and ``bench/run.py`` refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench.harness import spec
from bench.tests import cpu_cell, faults

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CLOSED = next(c for c in CELLS if spec.traffic(
    spec.cell(spec.benchmark(), c)["traffic"])["loop"] == "closed")
# the widest gap the CPU runs are held to (reduced minicpm3, 24-token
# prompts, 4 new tokens, 12 requests checked): sound runs read 0 to
# 0.0048 on seeds 1-4, the fp8 control 0.034 to 0.18, the planted faults
# 0.53 to 1.19
LIMIT = 0.015


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, lines = cpu_cell.run(cell, seed=1, limit=LIMIT)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in spec.metrics(spec.benchmark(), cell, False)}
    assert want == set(res["metrics"]) and "setup_s" in want
    assert list(res)[-1] == "check"
    assert lines[0].startswith("check: widest_gap=")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_host_and_span_metrics(cell):
    res, _ = cpu_cell.run(cell, seed=2, trace=True, limit=LIMIT)
    got = res["metrics"]
    want = {m["name"] for m in spec.metrics(spec.benchmark(), cell, True)}
    # no card, no peak and no device trace: those readers return nothing
    device = {"mfu.prefill", "gpu_idle.closed"}
    assert set(got) == want - device and got
    if "slot_occupancy" in got:
        assert 0 < got["slot_occupancy"]["value"] <= 1


@pytest.mark.parametrize("fault", sorted(faults.ALL))
def test_fault_in_the_timed_path_is_not_correct(fault):
    # the closed loop keeps every slot live, so a fault in one slot or in
    # half of them reaches the sampled requests
    res, lines = cpu_cell.run(CLOSED, seed=1, seconds=2.0, limit=LIMIT,
                              plant=faults.ALL[fault],
                              cell={"check_requests": 12})
    assert not res["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_fails_where_the_program_passes(cell):
    for seed in (1, 2, 3):
        res, _ = cpu_cell.run(cell, seed=seed, limit=LIMIT, control=True,
                              cell={"check_requests": 12})
        got = res["check"]["widest_gap"]["value"]
        assert got <= LIMIT < res["control_widest_gap"]


def _run_py(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_run_refuses_without_a_card():
    got = _run_py(ROOT)
    assert got.returncode != 0 and _no_result(got.stdout), got.stderr


def test_run_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".state", "__pycache__"))
    got = _run_py(tmp_path)
    assert got.returncode != 0 and _no_result(got.stdout), got.stderr


@pytest.mark.needs_cuda
def test_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    got = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0],
         "--seed", "2147483999", "--seconds", "8", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"]
