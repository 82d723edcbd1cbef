"""Cold-vs-warm first-call latency: what a *fresh process* pays.

    PYTHONPATH=src python -m repro_torch.benchmarks.cold_start

Two costs are measured, each in its own subprocess (one that imports
only ``repro_torch``), so tune caches and calibration stores are
genuinely cold:

* **Autotune search** — per kernel (conv2d, hist, flash_attention,
  gmm): the model-ranked top-K search (``REPRO_TUNE_TOPK``, the
  default) against the exhaustive full search (``REPRO_TUNE_TOPK=0``),
  on fresh tune files, then a warm lookup that must measure nothing,
  and transfer to the neighbour bucket, which must measure once.  The
  top-K search runs first, so it pays every first-use cost and the
  full search inherits a warm process — the reported speedup is
  conservative.  Winner quality: both winners timed head to head
  (``winner_time_ratio`` = top-K winner time / full winner time; 1.0
  when they are the same config).
* **Hybrid calibration** — process A runs the conv workload twice on a
  fresh calibration store (probing, converging, persisting); process B
  starts cold on the same store and must plan its first call with 0
  probe runs (``HybridExecutor.last_probe_runs``) and a plan within one
  chunk per group of the plan A makes next from what it persisted.
  (A's second call itself may run the sticky plan, damped toward its
  first call's rates, while B plans from the second call's rates: that
  plan's distance is printed too, as ``last_plan_delta_units``.)
  ``REPRO_COST_MODEL=0`` in both, so the match shows *persistence*, not
  model priors.

The children run on the first GPU (the hybrid pair: the GPU and the
CPU) and raise without one; ``run(device="cpu")`` runs them on the
CPU (the simulated pair).  ``root`` is where the throwaway stores go
(default: the system's temporary directory).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

KERNELS = ("conv2d", "hist", "flash_attention", "gmm")
# each kernel's shape and its neighbour bucket's (the reference's)
SHAPES = {
    "conv2d": {"n": 512, "neighbor": 768, "K": 15},
    "hist": {"n": 1 << 20, "neighbor": 1 << 19, "bins": 256},
    "flash_attention": {"T": 1024, "neighbor": 512, "H": 8, "Kv": 2,
                        "d": 64},
    "gmm": {"C": 256, "neighbor": 512, "E": 8, "D": 256, "F": 512},
}


# ---------------------------------------------------------------------------
# Child-process workers (each also callable in-process)
# ---------------------------------------------------------------------------
def setup(kernel: str, neighbor: bool = False, device=None):
    """(tuned_config thunk, run(cfg) thunk, candidates) of ``kernel`` at
    its ``SHAPES`` entry on ``device`` (default: the first GPU);
    ``neighbor=True`` builds the sibling shape one bucket over (the
    cross-shape-transfer target).  ``run`` returns the op's output
    without waiting for it."""
    import torch

    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(5)
    s = SHAPES[kernel]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    if kernel == "conv2d":
        from repro_torch.kernels.conv2d import ops
        n = s["neighbor"] if neighbor else s["n"]
        img, w = randn(n, n), randn(s["K"], s["K"])
        return (lambda: ops.tuned_config(img, w),
                lambda cfg: ops.conv2d(img, w, config=cfg),
                ops.candidates(n, n, s["K"], dev))
    if kernel == "hist":
        from repro_torch.kernels.hist import ops
        n = s["neighbor"] if neighbor else s["n"]
        x = torch.randint(0, s["bins"], (n,), generator=gen,
                          dtype=torch.int32).to(dev)
        return (lambda: ops.tuned_config(x, s["bins"]),
                lambda cfg: ops.histogram(x, s["bins"], config=cfg),
                ops.candidates(n, s["bins"], dev))
    if kernel == "flash_attention":
        from repro_torch.kernels.flash_attention import ops
        t = s["neighbor"] if neighbor else s["T"]
        bf = torch.bfloat16
        q = randn(1, t, s["H"], s["d"], dtype=bf)
        k = randn(1, t, s["Kv"], s["d"], dtype=bf)
        v = randn(1, t, s["Kv"], s["d"], dtype=bf)
        return (lambda: ops.tuned_config(q, k, v),
                lambda cfg: ops.flash_attention(q, k, v, config=cfg),
                ops.candidates(t, t, s["d"], True, dev, bf))
    if kernel == "gmm":
        from repro_torch.kernels.gmm import ops
        c = s["neighbor"] if neighbor else s["C"]
        bf = torch.bfloat16
        xe = randn(s["E"], c, s["D"], dtype=bf)
        we = randn(s["E"], s["D"], s["F"], dtype=bf)
        return (lambda: ops.tuned_config(xe, we),
                lambda cfg: ops.gmm(xe, we, config=cfg),
                ops.candidates(s["E"], c, s["D"], s["F"], dev, bf))
    raise ValueError(kernel)


def child_profile(device=None) -> dict:
    """Measure the device's hardware profile once into the (parent-
    supplied, throwaway) REPRO_CALIB_CACHE store, so the search
    children get a disk hit instead of measuring it inside their timed
    search."""
    from repro_torch.core import cost_model
    from repro_torch.kernels.common import resolve_device
    cost_model.get_profile(resolve_device(device))
    return {"ok": True}


def child_search(kernel: str, tmpdir: str, mode: str, rival_cfg: str = "",
                 device=None) -> dict:
    """One genuinely cold search in THIS process.  mode="topk" uses the
    default model-ranked search, then a warm lookup and transfer to the
    neighbour bucket; mode="full" disables ranking and transfer and,
    when the top-K winner differs (``rival_cfg``), times both winners
    head to head.  Sets the tune knobs in ``os.environ``."""
    os.environ["REPRO_AUTOTUNE"] = "1"
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmpdir, mode + ".json")
    if mode == "full":
        os.environ["REPRO_TUNE_TOPK"] = "0"
        os.environ["REPRO_TUNE_TRANSFER"] = "0"
    else:
        os.environ.pop("REPRO_TUNE_TOPK", None)
        os.environ.pop("REPRO_TUNE_TRANSFER", None)
    from repro_torch.core.calibration import measure
    from repro_torch.kernels import autotune as at

    tuned, run, cands = setup(kernel, device=device)
    calls = []
    default_timer = at._default_timer

    def timer(fn):
        calls.append(1)
        return default_timer(fn)

    prev = at.set_timer(timer)
    try:
        at.reset_tune_cache()
        t0 = time.perf_counter()
        cfg = tuned()                          # cold: search
        t_search = time.perf_counter() - t0
        n_measured = len(calls)

        at.reset_tune_cache()                  # drop memory, keep file
        calls.clear()
        t0 = time.perf_counter()
        cfg_warm = tuned()                     # pure disk lookup
        t_warm = time.perf_counter() - t0
        if cfg_warm != cfg:
            raise AssertionError(f"warm lookup {cfg_warm} != {cfg}")
        out = {"t_search": t_search, "t_warm": t_warm,
               "n_measured": n_measured, "n_warm": len(calls),
               "n_candidates": len(cands), "cfg": cfg}
        if mode == "topk":
            # neighbour bucket: seeded by transfer (1 measurement)
            calls.clear()
            tuned_nb, _, _ = setup(kernel, neighbor=True, device=device)
            t0 = time.perf_counter()
            out["cfg_transfer"] = tuned_nb()
            out["t_transfer"] = time.perf_counter() - t0
            out["n_transfer"] = len(calls)
    finally:
        at.set_timer(prev)
    if mode == "full" and rival_cfg:
        rival = json.loads(rival_cfg)
        if rival != cfg:
            t_mine = measure(lambda: run(cfg), warmup=1, iters=3,
                             reduce="min")
            t_rival = measure(lambda: run(rival), warmup=1, iters=3,
                              reduce="min")
            out["winner_time_ratio"] = t_rival / max(t_mine, 1e-9)
    return out


def child_hybrid(phase: int, tmpdir: str, device=None, size: int = 512,
                 ksize: int = 15) -> dict:
    """The conv workload's first call in THIS process on the stores in
    ``tmpdir`` (phase 1 also runs a second call, which converges and
    persists the calibration, and reports the plan it would make next
    from it as ``next_plan``).  Sets the store knobs in ``os.environ``."""
    os.environ["REPRO_CALIB_CACHE"] = os.path.join(tmpdir, "calib.json")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmpdir, "tune.json")
    os.environ["REPRO_COST_MODEL"] = "0"       # isolate persistence
    os.environ["REPRO_AUTOTUNE"] = "1"
    from repro_torch.core.hybrid_executor import (HybridExecutor,
                                                  _assigned_units)
    from repro_torch.kernels import autotune as at
    from repro_torch.workloads import conv

    at.reset_tune_cache()
    ex = HybridExecutor(n_chunks=16, device=device)
    t0 = time.perf_counter()
    out = conv.run_hybrid(ex, size=size, ksize=ksize)
    t_first = time.perf_counter() - t0
    probes_first = ex.last_probe_runs
    res = {}
    if phase == 1:                             # converge + persist
        out = conv.run_hybrid(ex, size=size, ksize=ksize)
        # persist now: the store defers refinements of known keys (2 s
        # debounce, else at exit), so a process B started before A's
        # exit flush would plan from A's first call
        ex.cache.flush()
        # the split this process plans next, from the calibration it has
        # just persisted: all hits, so nothing is probed or stored
        ex.calibrate(lambda g, n: None, probe_units=1,
                     workload=f"Conv/{size}x{ksize}")
        if ex.last_probe_runs:
            raise AssertionError("a group has no persisted calibration")
        names = [g.name for g in ex.groups]
        nxt = _assigned_units(ex.plan(size, out.plan.comm_cost).units,
                              names, max(size // ex.n_chunks, 1))
        res["next_plan"] = {n: u for n, u in zip(names, nxt) if u}
    plan = {}
    for c in out.trace.chunks:
        plan[c.owner] = plan.get(c.owner, 0) + c.units
    return {**res, "probes_first_call": probes_first, "plan": plan,
            "t_first": t_first, "chunk_units": size // 16,
            "simulated": ex.simulated}


# ---------------------------------------------------------------------------
# Parent: orchestrate subprocesses, print CSV rows
# ---------------------------------------------------------------------------
def _spawn(args, extra_env=None, timeout: float = 600):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra_env or {})
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.cold_start"] + args,
        capture_output=True, text=True, timeout=timeout, env=env)
    if res.returncode != 0:
        raise RuntimeError(f"cold_start child {args} failed:\n"
                           f"{res.stdout}\n{res.stderr}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


def run(device=None, root=None, kernels=KERNELS) -> dict:
    """Spawn the children and print one CSV row per measurement
    (name,us,derived); returns the rows' numbers by name.  A child that
    fails raises."""
    dev = ["--device", str(device)] if device is not None else []
    rows = {}
    with tempfile.TemporaryDirectory(prefix="repro-cold-", dir=root) as d:
        calib_env = {"REPRO_CALIB_CACHE": os.path.join(d, "calib.json")}
        _spawn(["--child", "profile"] + dev, calib_env)
        for kernel in kernels:
            kd = os.path.join(d, kernel)
            os.makedirs(kd)
            topk = _spawn(["--child", "search", "--kernel", kernel,
                           "--tmpdir", kd, "--mode", "topk"] + dev,
                          calib_env)
            full = _spawn(["--child", "search", "--kernel", kernel,
                           "--tmpdir", kd, "--mode", "full",
                           "--rival-cfg", json.dumps(topk["cfg"])] + dev,
                          calib_env)
            speedup = full["t_search"] / max(topk["t_search"], 1e-9)
            match = topk["cfg"] == full["cfg"]
            # identical winners are by definition equally fast; only a
            # differing pick gets the measured head-to-head ratio
            ratio = 1.0 if match else full.get("winner_time_ratio", 1.0)
            print(f"cold_start/{kernel}_search_full,"
                  f"{full['t_search'] * 1e6:.0f},"
                  f"measured={full['n_measured']}/{full['n_candidates']}"
                  f"|winner={json.dumps(full['cfg'], sort_keys=True)}")
            print(f"cold_start/{kernel}_search_topk,"
                  f"{topk['t_search'] * 1e6:.0f},"
                  f"speedup={speedup:.2f}x|measured={topk['n_measured']}"
                  f"|winner_match={match}|winner_time_ratio={ratio:.2f}"
                  f"|winner={json.dumps(topk['cfg'], sort_keys=True)}")
            print(f"cold_start/{kernel}_transfer_bucket,"
                  f"{topk['t_transfer'] * 1e6:.0f},"
                  f"measured={topk['n_transfer']}|seeded_from_sibling")
            print(f"cold_start/{kernel}_warm_lookup,"
                  f"{topk['t_warm'] * 1e6:.0f},"
                  f"measured={topk['n_warm']}|cache_hit", flush=True)
            rows[kernel] = {"topk": topk, "full": full, "speedup": speedup,
                            "winner_match": match,
                            "winner_time_ratio": ratio}
        hd = os.path.join(d, "hybrid")
        os.makedirs(hd)
        a = _spawn(["--child", "hybrid", "--phase", "1", "--tmpdir", hd]
                   + dev)
        b = _spawn(["--child", "hybrid", "--phase", "2", "--tmpdir", hd]
                   + dev)
    cu = a["chunk_units"]

    def delta(p, q):
        return max(abs(p.get(g, 0) - q.get(g, 0)) for g in set(p) | set(q))
    max_delta = delta(a["next_plan"], b["plan"])
    last_delta = delta(a["plan"], b["plan"])
    print(f"cold_start/hybrid_conv_first_call,{b['t_first'] * 1e6:.0f},"
          f"probes={b['probes_first_call']}"
          f"|plan_match={max_delta <= cu}"
          f"|max_plan_delta_units={max_delta}"
          f"|last_plan_delta_units={last_delta}"
          f"|cold_probes={a['probes_first_call']}"
          f"|simulated={b['simulated']}", flush=True)
    rows["hybrid"] = {"a": a, "b": b, "plan_match": max_delta <= cu,
                      "max_plan_delta_units": max_delta,
                      "last_plan_delta_units": last_delta}
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=["search", "hybrid", "profile"])
    ap.add_argument("--kernel", default="conv2d")
    ap.add_argument("--mode", default="topk", choices=["topk", "full"])
    ap.add_argument("--rival-cfg", default="")
    ap.add_argument("--phase", type=int, default=1)
    ap.add_argument("--tmpdir", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.child == "search":
        out = child_search(args.kernel, args.tmpdir, args.mode,
                           args.rival_cfg, args.device)
    elif args.child == "hybrid":
        out = child_hybrid(args.phase, args.tmpdir, args.device)
    elif args.child == "profile":
        out = child_profile(args.device)
    else:
        run(args.device)
        return
    print("RESULT" + json.dumps(out))


if __name__ == "__main__":
    main()
