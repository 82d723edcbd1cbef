"""Scenario portfolio runner: replay every ``*.json`` scenario in this
directory through a fresh Scheduler and emit regress-gated
``serving/scenario_*`` CSV rows (per-SLO-class p95 + goodput) plus an
informational counters row per scenario.

The specs are copies of the reference's ``benchmarks/scenarios/*.json``
(``tests/test_torch_scenario.py`` holds them equal); this runner reads
only its own copies.  Each scenario runs on the GPU + CPU pair and
raises without a GPU; ``device="cpu"`` / ``--device cpu`` runs the
simulated pair on the CPU::

    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios.run_scenarios \
        --smoke --json scenario_smoke.json

or via ``repro_torch.benchmarks.run`` / ``serving_bench.run`` (the
scenario section).  Exit status is nonzero when any scenario violates
the accounting invariant (``dropped_without_rejection != 0``), when a
chaos scenario failed to actually kill a lane, or when the closed-loop
scenario left a client hanging — the correctness contract gates, the
latency rows only trend.
"""
import argparse
import json
import os
import sys
import time

# Bump when scenario specs or the metric definitions change: the
# version rides in every row name so regress.py compares like to like.
SCENARIO_VERSION = "s1"

_HERE = os.path.dirname(os.path.abspath(__file__))


def list_specs(only=None):
    """All scenario specs in this directory, sorted by file name."""
    from repro_torch.serve.scenario import load_spec
    specs = []
    for fn in sorted(os.listdir(_HERE)):
        if not fn.endswith(".json"):
            continue
        spec = load_spec(os.path.join(_HERE, fn))
        if only and spec.name not in only:
            continue
        specs.append(spec)
    return specs


def _warm(specs, device=None) -> None:
    """Run every (workload, payload-bucket) once on every group's
    device before any scenario runs — first-arrival latencies must
    measure the scheduler, not first-use costs (input making, kernel
    library load, the caching allocator's growth)."""
    from repro_torch.core.hybrid_executor import detect_platform
    from repro_torch.kernels.common import lane_device
    from repro_torch.workloads import requests as adapters

    groups, _ = detect_platform(device=device)
    seen = set()
    for spec in specs:
        for wl, cfg in sorted(spec.workloads.items()):
            payloads = cfg.get("payload")
            if not isinstance(payloads, list):
                payloads = [payloads]
            for payload in payloads:
                key = (wl, json.dumps(payload, sort_keys=True))
                if key in seen:
                    continue
                seen.add(key)
                s = adapters.make_request(wl, payload)
                for g in groups:
                    with lane_device(g.devices[0]):
                        s.run_one()


def run_one(spec, smoke: bool = False, device=None):
    """One scenario through one fresh Scheduler; returns the
    ``run_scenario`` result dict (plus ``ok``/``rows``)."""
    from repro_torch.ft.failure import ChaosInjector
    from repro_torch.serve.scenario import accounting_invariant, run_scenario
    from repro_torch.serve.scheduler import Scheduler

    injector = None
    if spec.faults:
        injector = ChaosInjector.from_spec(list(spec.faults))
    kwargs = dict(spec.sched)
    kwargs.setdefault("max_queue", 1 << 16)
    kwargs.setdefault("batch_window_s", 0.002)
    kwargs.setdefault("split_overhead_s", 1e-3)
    sched = Scheduler(policy="cost", failure_injector=injector,
                      device=device, **kwargs)
    try:
        result = run_scenario(spec, sched,
                              scale=0.4 if smoke else None,
                              injector=injector,
                              result_timeout_s=120.0)
    finally:
        sched.drain(timeout=60)
        counters = sched.stats.snapshot()
        counters["in_flight"] = sched.stats.in_flight
        sched.shutdown(timeout=30)
    # post-drain counters are the authoritative accounting snapshot
    # (run_scenario's snapshot may still see in-flight work)
    result["counters"] = counters
    result["dropped_without_rejection"] = accounting_invariant(counters)

    ok = result["dropped_without_rejection"] == 0
    if spec.faults and any("lane" in f for f in spec.faults):
        # a chaos scenario in which no lane died measured nothing
        ok = ok and counters.get("lane_deaths", 0) >= 1
    result["ok"] = ok

    v = SCENARIO_VERSION
    rows = []
    total_goodput = 0.0
    for cls_name, cm in sorted(result["classes"].items()):
        total_goodput += cm["goodput_rps"]
        rows.append(
            f"serving/scenario_{spec.name}_p95_{cls_name}_{v},"
            f"{cm['p95_s'] * 1e6:.0f},"
            f"p50={cm['p50_s'] * 1e3:.1f}ms|done={cm['completed']}|"
            f"rej={cm['rejected']}|"
            f"goodput={cm['goodput_rps']:.1f}rps")
    rows.append(
        f"serving/scenario_{spec.name}_goodput_{v},"
        f"{1e6 / max(total_goodput, 1e-9):.0f},"
        f"us_per_good_req|{total_goodput:.1f}rps|"
        f"mode={result['mode']}|events={result['n_events']}")
    c = counters
    rows.append(
        f"serving/scenario_info_{spec.name}_{v},"
        f"{result['elapsed_s'] * 1e6:.0f},"
        f"submitted={c['submitted']:.0f}|completed={c['completed']:.0f}|"
        f"shed_deadline={c['shed_deadline']:.0f}|"
        f"shed_brownout={c['shed_brownout']:.0f}|"
        f"lane_deaths={c.get('lane_deaths', 0):.0f}|"
        f"preempt={c.get('engine_preemptions', 0):.0f}|"
        f"dropped={result['dropped_without_rejection']}|"
        f"digest={result['digest'][:12]}")
    result["rows"] = rows
    return result


def run(smoke: bool = False, only=None, json_out=None,
        print_rows: bool = True, device=None):
    """Replay the portfolio; prints CSV rows (``print_rows=False``
    leaves printing to the caller, e.g. serving_bench's section, so
    rows never hit stdout twice); returns (ok, results)."""
    specs = list_specs(only=only)
    if not specs:
        print("# no scenario specs found")
        return False, []
    _warm(specs, device=device)
    ok = True
    results = []
    for spec in specs:
        t0 = time.time()
        result = run_one(spec, smoke=smoke, device=device)
        result["wall_s"] = time.time() - t0
        results.append(result)
        if print_rows:
            for row in result["rows"]:
                print(row)
        if not result["ok"]:
            ok = False
            print(f"# scenario {spec.name} FAILED: "
                  f"dropped={result['dropped_without_rejection']} "
                  f"lane_deaths="
                  f"{result['counters'].get('lane_deaths', 0):.0f}")
    if json_out:
        with open(json_out, "w") as fh:
            json.dump({"version": SCENARIO_VERSION, "ok": ok,
                       "results": results}, fh, indent=1, default=str)
        print(f"# wrote {json_out} ({len(results)} scenarios)")
    return ok, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="0.4x arrival rate (CI-sized)")
    ap.add_argument("--only", action="append", default=None,
                    help="run only this scenario (repeatable)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write per-scenario results JSON")
    ap.add_argument("--device", default=None,
                    help="accel device (default: the first GPU; 'cpu' "
                         "simulates the pair on the CPU)")
    args = ap.parse_args(argv)
    ok, _ = run(smoke=args.smoke, only=args.only, json_out=args.json,
                device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
