"""Bench-trajectory gate: fail when a kernel regresses vs its previous
``BENCH_torch_history.jsonl`` entry.

``python -m repro_torch.benchmarks.run --json`` appends one timestamped
row per kernel per run, keyed by the port's backend (``torch:cuda`` or
``torch:cpu``); this script compares, per (backend, kernel), the latest entry
against the one before it and exits non-zero when any kernel got more
than ``--threshold`` (default 20%) slower AND by more than
``--min-delta-us`` (default 100us — relative noise on a sub-100us
kernel is all dispatch jitter).  ``cold_start/*`` rows (fresh-process
first-call latency: autotune search cost, transfer seeding, calibrated
first hybrid call) gate too, at ``--cold-threshold`` (default 75%) and
a 50 ms minimum delta: subprocess cold numbers include jit compile
time, which swings far more than steady-state kernel time, but a
persistent multi-x cold-start regression (e.g. a broken cache path
silently re-searching) must still fail.  ``serving/*`` scheduler rows (p95
latency and us-per-request throughput from ``serving_bench.py`` — all
lower-is-better by construction) gate at ``--serving-threshold``
(default 60%) with a 20 ms minimum delta: open-loop queueing tails are
noisier than steady-state kernels, but a persistent multi-x p95 or
throughput regression (e.g. a broken placement path serializing all
lanes) must still fail.  Baseline rows (FIFO lanes, the monolithic LM
adapter), the fifo/sched and continuous/monolithic ratios and
probe-count rows are informational only (the baselines saturate by
design; ratios are higher-is-better).  Missing file, a single run,
or first-seen kernels all pass (no trajectory yet -> nothing to gate).

Usage: python -m repro_torch.benchmarks.regress [--threshold 0.2]
       [--cold-threshold 0.75] [--serving-threshold 0.6]
       [--min-delta-us 100] [--history PATH]

The thresholds and verdicts are the reference's
(``benchmarks/regress.py``); ``--history`` defaults to
``BENCH_torch_history.jsonl`` in the current directory.
"""
from __future__ import annotations

import argparse
import json
import sys

HISTORY = "BENCH_torch_history.jsonl"


def load_history(path: str):
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and "name" in row and "us" in row:
                    rows.append(row)
    except OSError:
        pass
    return rows


def check(rows, threshold: float, min_delta_us: float = 100.0,
          cold_threshold: float = 0.75, serving_threshold: float = 0.6):
    """Per (backend, kernel): (previous, latest) us; returns failures.

    Grouping includes the backend so a run on a different box/backend
    never diffs against another backend's trajectory.  cold_start/*
    rows use the looser ``cold_threshold`` and a 50 ms minimum delta
    (compile-time noise); serving/* rows use ``serving_threshold`` and
    a 20 ms minimum delta (queueing-tail noise).  serving ratio/count
    rows (``p95_ratio``, ``cold_probe``, ``chaos_ratio``,
    ``fleet_ratio``, ``fleet_cold_probe``) and the ``serving/obs_*``
    placement-audit/utilization rows are informational — ratios are
    higher-is-better, audit rows are diagnostics with no better
    direction — so they never gate; the chaos/fleet goodput/p95 rows
    and the ``serving/trace_overhead_*`` row gate via the normal
    serving/* rules."""
    by_name = {}
    for row in rows:                      # file order == append order
        key = (row.get("backend", "?"), row["name"])
        by_name.setdefault(key, []).append(row)
    failures, lines = [], []
    for backend, name in sorted(by_name):
        entries = by_name[(backend, name)]
        if name.startswith(("serving/p95_ratio", "serving/cold_probe",
                            "serving/lm_ratio", "serving/chaos_ratio",
                            "serving/fleet_ratio",
                            "serving/fleet_cold_probe",
                            "serving/obs_",
                            "serving/scenario_info_")):
            continue                      # higher-is-better / count /
            #                               diagnostic audit rows
        if name.startswith("serving/") and ("_fifo_" in name
                                            or "_mono_" in name):
            # baseline rows: the FIFO lane and the monolithic LM
            # adapter saturate by design at the top arrival rate; their
            # (legitimately bistable) queueing tails are context for
            # the ratio rows, not trajectories of ours
            continue
        cold = name.startswith("cold_start/")
        serving = name.startswith("serving/")
        thr = (cold_threshold if cold
               else serving_threshold if serving else threshold)
        min_delta = min_delta_us
        if cold:
            min_delta = max(min_delta_us, 50_000.0)
        elif serving:
            min_delta = max(min_delta_us, 20_000.0)
        name = f"[{backend}] {name}"
        if len(entries) < 2:
            lines.append(f"{name}: {entries[-1]['us']:.0f}us (first entry)")
            continue
        prev, last = entries[-2], entries[-1]
        if prev["us"] <= 0 or last["us"] <= 0:
            continue
        ratio = last["us"] / prev["us"]
        status = "OK"
        if ratio > 1 + thr and last["us"] - prev["us"] > min_delta:
            status = "REGRESSION"
            failures.append((name, prev["us"], last["us"], ratio))
        lines.append(f"{name}: {prev['us']:.0f}us -> {last['us']:.0f}us "
                     f"({ratio:.2f}x) {status}")
    return failures, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="max allowed fractional slowdown (0.2 = 20%%)")
    ap.add_argument("--cold-threshold", type=float, default=0.75,
                    help="max allowed fractional slowdown for "
                         "cold_start/* rows (compile-time noise)")
    ap.add_argument("--serving-threshold", type=float, default=0.6,
                    help="max allowed fractional slowdown for serving/* "
                         "p95/throughput rows (queueing-tail noise)")
    ap.add_argument("--min-delta-us", type=float, default=100.0,
                    help="ignore regressions smaller than this absolute "
                         "delta (dispatch jitter on tiny kernels)")
    ap.add_argument("--history", default=HISTORY)
    args = ap.parse_args(argv)

    rows = load_history(args.history)
    if not rows:
        print(f"regress: no history at {args.history} (nothing to gate)")
        return 0
    failures, lines = check(rows, args.threshold, args.min_delta_us,
                            args.cold_threshold, args.serving_threshold)
    for ln in lines:
        print("regress:", ln)
    if failures:
        print(f"regress: FAIL — {len(failures)} kernel(s) regressed "
              f">{args.threshold:.0%}")
        return 1
    print("regress: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
