"""Serving launcher: batched greedy generation for an assigned arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b \\
        --batch 4 --prompt-len 16 --new-tokens 16 [--full] [--hybrid | --stream]

Runs on the first GPU and raises without one.  ``main(argv,
device="cpu")`` runs it on the CPU from Python (``--hybrid`` and
``--stream`` then on the simulated pair).  Without ``--full`` the
config is ``reduced()``; with it, the architecture's full config (a
model whose weights must fit on the card).  Weights are random, from
seed 0; the prompt from seed 1.  An encoder-decoder arch (whisper) is
refused with ``SystemExit``, as in the reference.

``--hybrid`` splits ONE request batch across the detected device groups
through the chunk-pipelined ``HybridExecutor`` (rows = work units): on
the GPU + CPU pair the GPU's rows decode on the card while the CPU's
decode on a copy of the same weights in host memory, concurrently; the
report shows measured vs model makespan.

``--stream`` drives the serving subsystem instead: a synthetic
open-loop arrival trace (Poisson inter-arrivals at ``--rate`` req/s for
``--duration`` seconds) submitted to ``repro_torch.serve.Scheduler``,
which places each request (dedicated / work-shared / queued) from the
cost model, coalesces same-shape arrivals, and sheds what misses
``--deadline``.  Prints per-request latency percentiles and the
scheduler's load telemetry.  ``--trace out.json`` exports the run's
span timeline as Chrome trace-event JSON; ``--stats-json stats.json``
dumps the final ``ServeStats`` snapshot and the placement audit.

``--stream --continuous`` serves the trace through the
continuous-batching engine instead (``serve/continuous.py``): requests
of one shape stack into one slot-batched decode step, joining and
leaving at step boundaries; the engine's prefill and decode lanes are
printed (``engine <workload>: prefill=<group> decode=<group>``) and
kept in ``--stats-json``.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.kernels.common import current_device, resolve_device, sync
from repro_torch.models import model_zoo
from repro_torch.serve.serve_step import generate


def _percentiles(xs):
    if not xs:
        return {}
    arr = np.asarray(sorted(xs))
    return {p: float(np.percentile(arr, p)) for p in (50, 95, 99)}


def run_stream(cfg, params, args, groups=None, device=None) -> dict:
    """Open-loop arrival trace through the serving scheduler.

    ``groups`` (default: the detected pair for ``device``) are the
    scheduler's device groups; the LM adapter gets a copy of the weights
    on each group's device, made once before the trace.  Returns the
    trace's numbers and every served request's tokens."""
    from repro_torch.serve.request_queue import RequestRejected
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.workloads import requests as adapters

    sched = Scheduler(groups=groups, device=device,
                      max_batch=args.max_batch,
                      batch_window_s=args.window_ms / 1e3)
    devs = [g.devices[0] for g in sched.groups if g.devices]
    if args.continuous:
        wl = adapters.make_continuous_lm_adapter(
            cfg, params, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens, devices=devs)
        adapters.wait_precompiled(timeout=600)
    else:
        wl = adapters.make_lm_adapter(cfg, params,
                                      prompt_len=args.prompt_len,
                                      new_tokens=args.new_tokens,
                                      devices=devs)
    try:
        # one warmup request outside the measured trace: first-use
        # costs (kernel build, allocator growth) are a property of the
        # process, not of the scheduler under test
        sched.submit(wl, {"batch": args.batch}).result(timeout=600)

        rng = np.random.default_rng(0)
        futs = []
        done_at = {}
        done_lock = threading.Lock()

        def stamp(f):
            with done_lock:
                done_at[id(f)] = time.perf_counter()

        t_end = time.perf_counter() + args.duration
        t0 = time.perf_counter()
        while time.perf_counter() < t_end:
            f = sched.submit(wl, {"batch": args.batch},
                             deadline=args.deadline)
            # completion stamped by the resolving thread: awaiting
            # futures in submission order would record trace position,
            # not latency
            f.add_done_callback(stamp)
            # the engine's token stamps are on the scheduler's clock
            futs.append((time.perf_counter(), sched.clock(), f))
            # open-loop: the NEXT arrival does not wait for this result
            time.sleep(float(rng.exponential(1.0 / max(args.rate, 1e-6))))
        lat, tokens, rejected, decode, ttft = [], [], 0, [], []
        for t_sub, t_sub_clock, f in futs:
            try:
                tokens.append(f.result(timeout=600))
                lat.append(done_at[id(f)] - t_sub)
            except RequestRejected:
                rejected += 1
                continue
            # the engine stamps the first token after prefill and the
            # last at the final eviction: completion-callback time alone
            # can't separate queueing from decode
            t_ft = f.meta.get("t_first_token")
            t_lt = f.meta.get("t_last_token")
            if t_ft is not None:
                ttft.append(t_ft - t_sub_clock)
                if t_lt is not None:
                    decode.append(t_lt - t_ft)
        wall = (max(done_at.values()) - t0) if done_at \
            else time.perf_counter() - t0
        placements = dict(sched.engine_placements)
        audit = sched.audit.summary()
    finally:
        sched.shutdown()
    if args.stats_json:
        doc = {"arch": cfg.name, "stats": sched.stats.snapshot(),
               "placement_audit": audit,
               "engine_placements": {
                   name: {"prefill": plan.prefill_group,
                          "decode": plan.decode_group,
                          "disaggregated": plan.disaggregated,
                          "est_prefill_s": plan.est_prefill_s,
                          "est_decode_s": plan.est_decode_s}
                   for name, plan in placements.items()}}
        with open(args.stats_json, "w") as fh:
            json.dump(doc, fh, indent=2, default=str)
        print(f"stats json -> {args.stats_json}")
    if args.trace:
        from repro_torch.obs import get_recorder
        n = get_recorder().export_chrome(args.trace)
        print(f"trace -> {args.trace} ({n} events)")
    pct = _percentiles(lat)
    print(f"{cfg.name}: {len(futs)} requests over {wall:.1f}s "
          f"(rate {args.rate}/s), {len(lat)} served, {rejected} "
          f"rejected/shed on {[str(d) for d in devs]}")
    if pct:
        print(f"latency p50={pct[50] * 1e3:.1f}ms "
              f"p95={pct[95] * 1e3:.1f}ms p99={pct[99] * 1e3:.1f}ms "
              f"throughput={len(lat) / wall:.2f} req/s")
    dpct = _percentiles(decode)
    if dpct:
        print(f"decode p50={dpct[50] * 1e3:.1f}ms "
              f"p95={dpct[95] * 1e3:.1f}ms p99={dpct[99] * 1e3:.1f}ms "
              f"({len(decode)} stamped)")
    for name, plan in placements.items():
        print(f"engine {name}: prefill={plan.prefill_group} "
              f"decode={plan.decode_group} "
              f"disaggregated={plan.disaggregated}")
    # fault-tolerance counters: a clean run prints all zeros, which is
    # itself the signal — nonzero retries/failovers under a healthy
    # fleet mean a lane is flapping
    st = sched.stats
    print(f"ft: retries={st.retries} failovers={st.failovers} "
          f"lane_deaths={st.lane_deaths} revivals={st.lane_revivals} "
          f"hedges={st.hedges}/{st.hedge_wins} "
          f"watchdog={st.watchdog_timeouts} "
          f"brownout_shed={st.shed_brownout}")
    print(st.row())
    return {"workload": wl, "latency_s": lat, "tokens": tokens,
            "rejected": rejected, "wall_s": wall, "stats": st,
            "audit": audit, "ttft_s": ttft, "decode_s": decode,
            "engine_placements": placements}


def run_hybrid(cfg, params, prompt, new_tokens: int, device=None,
               plan_override=None):
    """Split one batch's rows across the detected groups: each group
    decodes its rows on its own device from its own copy of the weights
    and of the prompt (copies made here, once, outside the timed call).
    ``plan_override`` forces the rows per group, in the groups' order.
    Returns the executor's ``WorkSharedOutput``; the tokens gather on
    the first group's device."""
    from repro_torch.core.cost_model import lm_decode_terms
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.models.param import count_params
    from repro_torch.workloads.requests import params_to

    B = prompt.shape[0]
    cache_len = prompt.shape[1] + new_tokens + 1
    ex = HybridExecutor(n_chunks=min(4, B), device=device)
    on = {}
    for g in ex.groups:
        dev = g.devices[0]
        if str(dev) not in on:
            on[str(dev)] = (params_to(params, dev), sync(prompt.to(dev)))
    dest = ex.groups[0].devices[0]

    def run_share(group, start, k):
        w, p = on[str(current_device())]
        return sync(generate(cfg, w, p[start:start + k], new_tokens,
                             cache_len=cache_len))

    def combine(outs):
        return sync(torch.cat([o.to(dest) for o in outs], dim=0))

    # the decode roofline prior: a cold cache plans with zero probe
    # runs, so no group decodes rows it does not own inside the timed
    # path
    unit_cost = lm_decode_terms(count_params(params), new_tokens + 1)
    ex.calibrate(lambda g, k: run_share(g, 0, k),
                 probe_units=max(B // 2, 1), workload=f"serve/{cfg.name}",
                 unit_cost=unit_cost)
    return ex.run_work_shared(f"serve/{cfg.name}", B, run_share, combine,
                              plan_override=plan_override)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--hybrid", action="store_true",
                    help="work-share the batch across device groups")
    ap.add_argument("--stream", action="store_true",
                    help="drive the serving scheduler with a synthetic "
                         "open-loop arrival trace")
    ap.add_argument("--continuous", action="store_true",
                    help="--stream via the continuous-batching engine")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="--stream mean arrival rate, requests/s")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="--stream trace length, seconds")
    ap.add_argument("--deadline", type=float, default=None,
                    help="--stream per-request deadline, seconds")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="--stream: export Chrome trace-event JSON of "
                         "the run's span timeline")
    ap.add_argument("--stats-json", type=str, default=None,
                    metavar="PATH",
                    help="--stream: dump the final ServeStats snapshot "
                         "+ placement audit as JSON")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec serving: see tests/test_archs.py whisper "
                         "decode path")
    dev = resolve_device(device)
    params = model_zoo.init(cfg, 0, device=dev)

    if args.stream:
        return run_stream(cfg, params, args, device=device)

    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    cache_len = args.prompt_len + args.new_tokens + 1

    if args.hybrid:
        t0 = time.perf_counter()
        ws = run_hybrid(cfg, params, prompt, args.new_tokens, device=device)
        dt = time.perf_counter() - t0
        print(f"{cfg.name}: generated {tuple(ws.value.shape)} hybrid in "
              f"{dt:.2f}s")
        print(ws.result.row())
        return ws

    t0 = time.perf_counter()
    out = sync(generate(cfg, params, prompt, args.new_tokens,
                        cache_len=cache_len))
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: generated {tuple(out.shape)} in {dt:.2f}s on {dev}")
    return out


if __name__ == "__main__":
    main()
