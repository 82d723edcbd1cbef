"""One run of one cell: set-up, the window, the readings, the check.

``run`` is what ``bench/run.py`` calls on the card; the tests call it on
the CPU at a reduced size (``Overrides``), which is the only thing that
differs between the two.
"""
from __future__ import annotations

import gc
import statistics
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import torch

from bench.harness import check, serve, spec, traffic, weights
from bench.harness.trace import Profiler
from bench.reference.model import fp8_matmul

PROFILE_S = 6.0            # the profiled stretch, or 0.3 of a shorter window
PROFILE_END = 1.0          # ends this long before the close


@dataclass
class Overrides:
    """A reduced run for the tests: the program's config (``reduced()``),
    traffic keys, the cell's keys, the device group, and faults planted
    in the stepper's calls (``faults.py``)."""
    arch: Optional[Callable] = None            # ArchConfig -> ArchConfig
    conf: Dict[str, object] = field(default_factory=dict)
    traffic: Dict[str, object] = field(default_factory=dict)
    cell: Dict[str, object] = field(default_factory=dict)
    group: object = None
    plant: Optional[Callable] = None           # stepper -> None


def _served_records(records, close):
    return [r for r in records if r.ok and r.done_at is not None
            and r.done_at <= close]


def run(bench: dict, cell: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, note: Callable[[str], None] = print,
        over: Optional[Overrides] = None, control: bool = False):
    """Returns (the result line's object, the check's lines).  With
    ``control`` the check also reads the fp8 control's gaps on the same
    sample (``control.py``; never in a benchmark run)."""
    from repro_torch.configs import registry
    from repro_torch.obs import get_recorder

    over = over or Overrides()
    conf = dict(spec.config(bench, cell["config"]), **over.conf)
    mix = dict(spec.traffic(cell["traffic"]), **over.traffic)
    params_c = dict(spec.cell_params(cell["name"]), **over.cell)
    cfg = registry.get(conf["registry_name"])
    if over.arch is not None:
        cfg = over.arch(cfg)
    wrong = spec.mismatches(conf, cfg)
    if wrong:
        raise SystemExit(f"bench: {cfg.name} as the program builds it "
                         f"differs from {cell['config']}'s file: {wrong}")
    P, N = int(mix["prompt_len"]), int(mix["new_tokens"])
    S = int(conf["n_slots"])

    # ---- set-up ---------------------------------------------------
    params, ref_w = weights.make(cfg, seed, device)
    sched_cell = traffic.make(mix, params_c, seconds, seed, cfg.vocab_size)
    warm = traffic.make(dict(mix, loop="open"), {"rate_rps": S + 1.0},
                        1.0, seed + 1, cfg.vocab_size).prompts
    served = serve.Served(cfg, params, prompt_len=P, new_tokens=N,
                          n_slots=S, name=f"bench/{cell['name']}",
                          group=over.group)
    if over.plant is not None:
        over.plant(served.stepper)
    served.warm(list(warm))
    rec = get_recorder()
    # a traced run profiles a stretch at the window's end; the profiler
    # slows the host and backs requests up, so the host's and the
    # program's readings stop where the stretch starts
    calls = prof = None
    hooks, spans, steady = {}, [], seconds
    if trace:
        calls = serve.wrap_stepper(served.stepper, served.clock)
        stretch = min(PROFILE_S, 0.3 * seconds)
        prof = Profiler(served.clock, stretch)
        steady = seconds - stretch - PROFILE_END

        def start_stretch():
            spans.extend(rec.events())
            prof.start()

        hooks = {steady: start_stretch, seconds - PROFILE_END: prof.stop}
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec.clear()
    setup_s = served.clock() - t_start

    # ---- the window -----------------------------------------------
    records, t0, close, lateness = serve.run_window(
        served, sched_cell, seconds, hooks)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dtrace = prof.result() if prof is not None else None
    served.close()
    del served
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if lateness:
        note(f"open-loop lateness_ms p50={1e3 * statistics.median(lateness)!r}"
             f" p90={1e3 * traffic.percentile(lateness, 90)!r} max="
             f"{1e3 * max(lateness)!r} over {len(lateness)} requests")
    failed = [r for r in records if not r.ok]
    for r in failed[:5]:
        note(f"request {r.index} failed: {r.error}")

    # ---- the readings ---------------------------------------------
    peaks = spec.load_json(spec.BENCH / "peaks.json").get(
        torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    ctx = SimpleNamespace(
        records=records, t0=t0, close=close, seconds=seconds,
        steady_end=t0 + steady, setup_s=setup_s, conf=conf, n_slots=S,
        prompt_len=P, new_tokens=N, calls=calls,
        spans=spans if trace else None, trace=dtrace, peaks=peaks,
        key_of={serve.prompt_key(sched_cell.prompts[r.index]): r
                for r in records})
    metrics = {}
    for m in spec.metrics(bench, cell["name"], trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    served_ok = [r for r in records if r.ok and r.t_first is not None]
    note("ttft_ms " + " ".join(f"{1e3 * (r.t_first - r.due):.1f}"
                               for r in served_ok))
    note("tpot_ms " + " ".join(f"{1e3 * (r.t_last - r.t_first) / N:.1f}"
                               for r in served_ok if r.t_last is not None))
    note(f"{len(records)} requests, {len(failed)} failed, "
         f"{len(_served_records(records, close))} completed in the window; "
         f"set-up {setup_s!r} s; metrics {metrics}")

    # ---- the check ------------------------------------------------
    picked = check.sample(records, int(params_c.get("check_requests", 32)),
                          seed)
    gaps, ctl_gaps = check.served_gaps(
        conf, ref_w, [sched_cell.prompts[r.index] for r in picked],
        [r.tokens for r in picked],
        control_mm=fp8_matmul if control else None)
    bad_shape = check.tokens_ok(records, cfg.vocab_size, N + 1)
    numbers = {"widest_gap": {"value": check.widest(gaps),
                              "limit": float(params_c["gap_limit"])},
               "requests_missing": {"value": len(failed), "limit": 0},
               "answers_malformed": {"value": bad_shape, "limit": 0}}
    correct = (len(picked) > 0 and all(
        v["value"] <= v["limit"] for v in numbers.values()))
    note(f"check: {len(picked)} requests, {gaps.numel()} served tokens "
         f"against the float32 reference: widest_gap="
         f"{check.widest(gaps)!r} mean_gap="
         f"{float(gaps.mean()) if gaps.numel() else float('nan')!r}")
    lines = [f"check: {k}={v['value']!r} limit={v['limit']!r}"
             for k, v in numbers.items()]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if trace and dtrace is not None:
        dev["busy_s"] = dtrace.busy()
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = breakdown(dtrace, calls)
    if ctl_gaps is not None:
        result["control_widest_gap"] = check.widest(ctl_gaps)
    result["check"] = numbers
    del params, ref_w
    return result, lines


def breakdown(dtrace, calls) -> dict:
    """The device operations that took most time in the stretch, and the
    device's idle time by the wrapped call the host was in."""
    by_name: Dict[str, float] = {}
    for name, a, b in dtrace.ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = ([("prefill", a, b) for a, b, _ in calls.prefills]
             + [("step", a, b) for a, b in calls.steps])
    idle: Dict[str, float] = {}
    for g0, g1 in dtrace.idle_gaps():
        left = g1 - g0
        for what, a, b in spans:
            o = min(b, g1) - max(a, g0)
            if o > 0:
                idle[f"idle in {what}"] = idle.get(f"idle in {what}", 0.0) + o
                left -= o
        if left > 0:
            idle["idle outside calls"] = idle.get("idle outside calls",
                                                  0.0) + left
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])}
