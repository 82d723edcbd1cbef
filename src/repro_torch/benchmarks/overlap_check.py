"""Measure real overlap: the chunk-pipelined executor against the
sequential-loop baselines, on the conv work-shared workload.

    PYTHONPATH=src python -m repro_torch.benchmarks.overlap_check [--json]

Three wall-clock numbers (steady state, warm calibration cache):

  legacy3x — the seed executor's semantics: every share executed three
             times (untimed warmup + min-of-2) in a serial Python loop.
  seq1x    — each chunk exactly once, still a serial loop (isolates the
             calibration-cache win from the concurrency win).
  async    — the chunk-pipelined executor (threads on the GPU + CPU
             pair, virtual clocks on a simulated pair).

The chunk grid is sized from a *measured* per-image conv time (each
chunk carries at least ``target_chunk_us`` of the accel lane's tuned
work), and ``floor`` is the measured concurrency capacity's inverse:
the lowest async/seq1x ratio this host can reach.

Runs the real pair (the first GPU and the CPU) and raises without a
GPU; ``run(device="cpu")`` runs the simulated pair on the CPU.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

from repro_torch.core.async_executor import primary_device
from repro_torch.core.calibration import measure
from repro_torch.core.hybrid_executor import HybridExecutor, detect_platform
from repro_torch.kernels.common import sync_device, to_device
from repro_torch.kernels.conv2d.ops import conv2d, tuned_config
from repro_torch.workloads import conv


def _wall(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _lane(dev, size: int, ksize: int):
    """(one tuned conv of the whole image on ``dev``, its time)."""
    img, w = to_device(conv.make_inputs(size, ksize), dev)
    cfg = tuned_config(img, w)

    def one():
        return conv2d(img, w, config=cfg)

    return one, measure(one, warmup=1, iters=3, reduce="min")


def concurrency_capacity(groups, size: int, ksize: int) -> float:
    """Total conv throughput of the pair's two lanes (``groups``) run
    concurrently, relative to running the same work one lane after the
    other (2.0 = perfect parallel headroom, 1.0 = fully contended).
    Each lane gets work worth the same time — the faster lane repeats
    its image about t_slow / t_fast times — so the number is the pair's
    capacity, not the ratio of its speeds.  Each lane's tuned kernels
    are themselves parallel (the CPU's over its cores, the GPU's lane
    needs a core to launch), so the achievable async/seq1x ratio is
    bounded by 1/capacity."""
    lanes = [_lane(primary_device(g), size, ksize) for g in groups]
    t_max = max(t for _, t in lanes)
    reps = [max(1, min(10_000, round(t_max / max(t, 1e-9))))
            for _, t in lanes]
    serial = sum(k * t for k, (_, t) in zip(reps, lanes))

    def worker(one, k, dev):
        for _ in range(k):
            one()
        sync_device(dev)

    ts = [threading.Thread(target=worker,
                           args=(one, k, primary_device(g)))
          for (one, _), k, g in zip(lanes, reps, groups)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    elapsed = time.perf_counter() - t0
    return max(serial / max(elapsed, 1e-9), 1e-3)


def scaled_chunks(dev, size: int, ksize: int,
                  target_chunk_us: float = 3000.0, lo: int = 2,
                  hi: int = 32):
    """Chunk count such that each chunk carries >= target_chunk_us of
    the accel lane's measured tuned-conv work.  Returns (n_chunks,
    t_img)."""
    _, t_img = _lane(dev, size, ksize)
    n = int(max(lo, min(hi, (t_img * 1e6) / max(target_chunk_us, 1.0))))
    return n, t_img


def run(size: int = 2048, ksize: int = 15, json_out: bool = False,
        target_chunk_us: float = 3000.0, device=None) -> dict:
    groups, _ = detect_platform(device=device)
    n_chunks, t_img = scaled_chunks(primary_device(groups[0]), size, ksize,
                                    target_chunk_us)
    capacity = concurrency_capacity(groups, size, ksize)
    floor = 1.0 / capacity
    ex = HybridExecutor(n_chunks=n_chunks, device=device)
    # warm: every chunk shape, the calibration cache, the EWMA plan
    # (two async rounds)
    conv.run_hybrid(ex, size=size, ksize=ksize)
    conv.run_hybrid(ex, size=size, ksize=ksize)
    conv.run_hybrid(ex, size=size, ksize=ksize, sequential=True)

    def legacy3x():
        for _ in range(3):           # seed: warmup + min-of-2 per share
            out = conv.run_hybrid(ex, size=size, ksize=ksize,
                                  sequential=True)
        return out

    t_legacy, _ = _wall(legacy3x)
    t_seq, _ = _wall(lambda: conv.run_hybrid(ex, size=size, ksize=ksize,
                                             sequential=True))
    t_async, out_async = _wall(lambda: conv.run_hybrid(
        ex, size=size, ksize=ksize))

    mode = out_async.trace.mode
    n_dev = len({str(d) for g in ex.groups for d in g.devices})
    r_seq = t_async / t_seq if t_seq else float("inf")
    r_legacy = t_async / t_legacy if t_legacy else float("inf")
    split = {g: u for g, u in out_async.trace.group_units.items()}
    rows = [
        f"overlap/legacy3x_wall,{t_legacy * 1e6:.0f},"
        f"seed_semantics_3x_execution",
        f"overlap/seq1x_wall,{t_seq * 1e6:.0f},serial_each_chunk_once",
        f"overlap/async_wall,{t_async * 1e6:.0f},mode={mode}|"
        f"steals={out_async.trace.steals}|n_devices={n_dev}|"
        f"n_chunks={n_chunks}|split={split}|plan={out_async.plan.units}",
        f"overlap/ratio_vs_seq1x,{1e6 * r_seq:.0f},ratio={r_seq:.3f}|"
        f"floor={floor:.2f}|capacity={capacity:.2f}x",
        f"overlap/ratio_vs_legacy3x,{1e6 * r_legacy:.0f},"
        f"ratio={r_legacy:.3f}|target<0.75",
    ]
    for row in rows:
        print(row, flush=True)
    result = {"legacy3x_wall": t_legacy, "seq1x_wall": t_seq,
              "async_wall": t_async, "ratio_vs_seq1x": r_seq,
              "ratio_vs_legacy3x": r_legacy, "mode": mode,
              "n_devices": n_dev, "steals": out_async.trace.steals,
              "n_chunks": n_chunks, "size": size, "ksize": ksize,
              "t_img": t_img, "split": split,
              "plan": list(out_async.plan.units),
              "concurrency_capacity": capacity, "floor": floor}
    if json_out:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--ksize", type=int, default=15)
    ap.add_argument("--target-chunk-us", type=float, default=3000.0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    run(args.size, args.ksize, json_out=args.json,
        target_chunk_us=args.target_chunk_us)
