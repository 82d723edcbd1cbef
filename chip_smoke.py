#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the hand-written CUDA kernels (``src/repro_torch/csrc/*.cu``)
   with ``nvcc`` for ``sm_90a`` into ``src/repro_torch/build/``.
3. Kernel phase: calls each kernel's wrapper on the card at the shapes
   the main path gives it and at ragged shapes, holds the result
   against its plain PyTorch version on the same inputs, and times
   kernel, plain version and (where one exists) the single PyTorch
   call that computes the same function, with CUDA events.
4. Hybrid phase: ``HybridExecutor()`` pairs the GPU (``accel``) with
   the CPU (``host``) in ``threads`` mode and runs conv (3600x3600,
   K=15), hist (2^26 keys, 256 bins) and spmv (n=8192) cold, warm,
   warm under ``torch.profiler`` (the GPU's busy share) and with a
   forced split that puts work on the CPU, checks every value against
   a CPU reference, and checks that every kernel on the path was
   launched.
5. Prints the kernels' numbers as one JSON line, the card line again,
   and, last, ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits non-zero.  It also exits
non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  The calibration store is kept in memory
(``REPRO_CALIB_CACHE=0``): the run writes nothing outside the checkout
except the kernel build under ``src/repro_torch/build/``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks, the bound of every kernel time below
PEAK_F32_FLOPS = 67e12           # f32 on the CUDA cores (no tensor cores)
PEAK_BYTES = 3.35e12             # HBM3 bytes/s

TOL = {"conv2d": 2e-4, "hist": 0, "spmv_ell": 2e-5, "probe_add_one": 0}
SOURCE = {
    "conv2d": ("src/repro_torch/csrc/conv2d.cu",
               "src/repro/kernels/conv2d/conv2d.py:41"),
    "hist": ("src/repro_torch/csrc/hist.cu",
             "src/repro/kernels/hist/hist.py:51"),
    "spmv_ell": ("src/repro_torch/csrc/spmv_ell.cu",
                 "src/repro/kernels/spmv/spmv.py:36"),
    "probe_add_one": ("src/repro_torch/csrc/probe.cu",
                      "src/repro/core/cost_model.py:154"),
}

CONV_SIZE, CONV_K = 3600, 15
HIST_N, HIST_BINS = 1 << 26, 256
SPMV_N, SPMV_DENSITY = 8192, 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def time_ms(torch, fn, flush, iters: int = 15, warm: int = 3) -> float:
    """Median CUDA-event time of one call, on the device.  Before each
    call a read of a buffer larger than the 50 MB L2 evicts the inputs
    (the main path reads every input cold; a read leaves no dirty lines
    to write back inside the timed call), then the GPU spins ~0.1 ms so
    that the host has enqueued the call before the start event fires:
    the wrapper's host-side cost stays outside the events."""
    times = []
    for i in range(warm + iters):
        flush.max()
        torch.cuda._sleep(200_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        if i >= warm:
            times.append(s.elapsed_time(e))
    return statistics.median(times)


def check(torch, name, out, ref, what) -> float:
    tol = TOL[name]
    if tol == 0:
        if not torch.equal(out, ref):
            raise AssertionError(f"{name} {what}: not exact, max diff "
                                 f"{(out - ref).abs().max().item()}")
        return 0.0
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol,
                               msg=lambda m: f"{name} {what}: {m}")
    return (out - ref).abs().max().item()


def kernel_phase(torch, np, dev, flush):
    from repro_torch.core.cost_model import probe_add_one
    from repro_torch.kernels.conv2d.conv2d import (conv2d_cuda,
                                                   conv2d_shift_add)
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.hist.hist import hist_cuda
    from repro_torch.kernels.hist.ref import hist_ref
    from repro_torch.kernels.spmv import ops as spmv_ops
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    from repro_torch.kernels.spmv.spmv import spmv_ell_cuda
    from repro_torch.workloads import spmv as spmv_w

    rng = np.random.default_rng(7)
    rows = []

    def row(name, err, ms, plain_ms, flops, nbytes, library_ms, shape):
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        src, rep = SOURCE[name]
        r = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": None, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": library_ms}
        print(f"kernel {name} {shape}: err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms={library_ms}")
        rows.append(r)

    # K1 conv2d: the main path's chunk (225 rows + 14 halo rows of the
    # 3600-wide image, K=15), then ragged shapes (odd H/W, K 3 and 15)
    for H, W, K in [(37, 101, 3), (50, 64, 15), (129, 77, 15), (1, 5, 3),
                    (CONV_SIZE, CONV_SIZE, CONV_K)]:
        img = torch.tensor(rng.standard_normal((H, W)).astype(np.float32),
                           device=dev)
        w = torch.tensor(rng.standard_normal((K, K)).astype(np.float32),
                         device=dev)
        out = conv2d_cuda(img, w)
        check(torch, "conv2d", out, conv2d_shift_add(img, w),
              f"{H}x{W} K={K}")
        check(torch, "conv2d", out, conv2d_ref(img, w),
              f"{H}x{W} K={K} against F.conv2d")
    H = CONV_SIZE // 16 + CONV_K - 1
    img = torch.tensor(rng.standard_normal((H, CONV_SIZE)).astype(
        np.float32), device=dev)
    w = torch.tensor(rng.standard_normal((CONV_K, CONV_K)).astype(
        np.float32), device=dev)
    err = check(torch, "conv2d", conv2d_cuda(img, w),
                conv2d_shift_add(img, w), "main path chunk")
    check(torch, "conv2d", conv2d_cuda(img, w), conv2d_ref(img, w),
          "main path chunk against F.conv2d")
    row("conv2d", err, time_ms(torch, lambda: conv2d_cuda(img, w), flush),
        time_ms(torch, lambda: conv2d_shift_add(img, w), flush, iters=10),
        2.0 * H * CONV_SIZE * CONV_K ** 2,
        4.0 * (2 * H * CONV_SIZE + CONV_K ** 2),
        time_ms(torch, lambda: conv2d_ref(img, w), flush),
        f"{H}x{CONV_SIZE} K={CONV_K}")

    # K2 hist: ragged N, a slice off a 16-byte boundary, keys out of
    # range (ignored), then the main path's chunk (4 of 64 units of 2^26)
    for n, bins, lo, hi in [(1000, 16, 0, 16), (4099, 7, -2, 9),
                            ((1 << 20) + 3, 4096, 0, 4096),
                            (5, 3, 0, 3)]:
        x = torch.tensor(rng.integers(lo, hi, n, dtype=np.int32),
                         device=dev)
        check(torch, "hist", hist_cuda(x, bins), hist_ref(x, bins),
              f"N={n} bins={bins}")
        check(torch, "hist", hist_cuda(x[1:], bins), hist_ref(x[1:], bins),
              f"N={n - 1} bins={bins} (offset slice)")
    n = HIST_N // 16
    x = torch.tensor(rng.integers(0, HIST_BINS, n, dtype=np.int32),
                     device=dev)
    err = check(torch, "hist", hist_cuda(x, HIST_BINS),
                hist_ref(x, HIST_BINS), "main path chunk")
    row("hist", err, time_ms(torch, lambda: hist_cuda(x, HIST_BINS), flush),
        time_ms(torch, lambda: hist_ref(x, HIST_BINS), flush),
        1.0 * n, 4.0 * (n + HIST_BINS),
        time_ms(torch, lambda: torch.bincount(x, minlength=HIST_BINS),
                flush), f"N={n} bins={HIST_BINS}")

    # K3 spmv ELL: ragged R, then the main path's ELL tiles (the
    # nnz-sorted matrix in 512-row tiles; the first holds the heavy rows)
    for R, K, C in [(1000, 37, 777), (33, 4, 100), (100, 80, 80)]:
        vals = torch.tensor(rng.standard_normal((R, K)).astype(np.float32),
                            device=dev)
        idx = torch.tensor(rng.integers(0, C, (R, K), dtype=np.int32),
                           device=dev)
        xv = torch.tensor(rng.standard_normal(C).astype(np.float32),
                          device=dev)
        check(torch, "spmv_ell", spmv_ell_cuda(vals, idx, xv),
              spmv_ell_ref(vals, idx, xv), f"R={R} K={K} C={C}")
    A = spmv_w.make_matrix(SPMV_N, SPMV_DENSITY)
    A_sorted = A[np.argsort(-(A != 0).sum(1))]
    xv = torch.tensor(spmv_w.make_vector(SPMV_N), device=dev)
    tiles = []
    for t0 in range(0, SPMV_N, 512):
        sub = A_sorted[t0:t0 + 512]
        tiles.append(spmv_ops.prepare(
            sub, k_threshold=int(max((sub != 0).sum(1).max(), 1)),
            device=dev))
    for i, m in enumerate(tiles):
        check(torch, "spmv_ell", spmv_ell_cuda(m.ell_vals, m.ell_idx, xv),
              spmv_ell_ref(m.ell_vals, m.ell_idx, xv), f"tile {i}")
    m = tiles[0]
    R, K = m.ell_vals.shape
    err = check(torch, "spmv_ell", spmv_ell_cuda(m.ell_vals, m.ell_idx, xv),
                spmv_ell_ref(m.ell_vals, m.ell_idx, xv), "main path tile 0")
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.arange(R, device=dev).repeat_interleave(K),
                     m.ell_idx.reshape(-1).long()]),
        m.ell_vals.reshape(-1), (R, SPMV_N),
        check_invariants=False).coalesce()
    x2 = xv[:, None]
    row("spmv_ell", err,
        time_ms(torch, lambda: spmv_ell_cuda(m.ell_vals, m.ell_idx, xv),
                flush),
        time_ms(torch, lambda: spmv_ell_ref(m.ell_vals, m.ell_idx, xv),
                flush),
        2.0 * R * K, 8.0 * R * K + 4.0 * R + 4.0 * SPMV_N,
        time_ms(torch, lambda: torch.sparse.mm(coo, x2), flush),
        f"R={R} K={K} C={SPMV_N}")

    # K4 probe_add_one at the cost model's (128, 128) probe tile
    t = torch.tensor(rng.standard_normal((128, 128)).astype(np.float32),
                     device=dev)
    err = check(torch, "probe_add_one", probe_add_one(t), t + 1.0,
                "128x128")
    row("probe_add_one", err,
        time_ms(torch, lambda: probe_add_one(t), flush),
        time_ms(torch, lambda: t + 1.0, flush),
        1.0 * t.numel(), 8.0 * t.numel(),
        time_ms(torch, lambda: torch.add(t, 1.0), flush), "128x128")
    return rows


# ---------------------------------------------------------------------------
# hybrid phase
# ---------------------------------------------------------------------------
def overlap_s(trace) -> float:
    """Seconds during which both groups were executing chunks."""
    spans = {}
    for r in trace.records:
        lo, hi = spans.get(r.group, (r.t_start, r.t_end))
        spans[r.group] = (min(lo, r.t_start), max(hi, r.t_end))
    if len(spans) < 2:
        return 0.0
    return max(0.0, min(h for _, h in spans.values())
               - max(lo for lo, _ in spans.values()))


def report(label, out) -> None:
    r = out.result
    split = {g: out.trace.group_units.get(g, 0) for g in r.busy_times}
    print(f"hybrid {label}: mode={r.mode} split={split} "
          f"plan={out.plan.units} chunks={r.n_chunks} steals={r.steals} "
          f"hybrid_time_s={r.hybrid_time!r} "
          f"makespan_s={out.trace.makespan!r} single_s={r.single_times} "
          f"gain={r.gain!r} idle={r.idle_fracs} "
          f"resource_efficiency={r.resource_efficiency!r} "
          f"analytic_s={r.analytic_time!r} "
          f"overlap_s={overlap_s(out.trace)!r}")
    if split.get("host", 0) == 0:
        print(f"hybrid {label}: finding: the host group ran 0 units")


def profiled(torch, label, fn):
    """Run ``fn`` under torch.profiler and print the GPU's busy time
    (device time summed over kernels and copies) against the call's
    hybrid_time, and the device time by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    rows = [(e.key, e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(t for _, t in rows) / 1e6
    span = out.result.hybrid_time
    print(f"hybrid {label}: gpu_busy_s={busy!r} "
          f"gpu_idle_share={1.0 - busy / span!r}")
    for key, t in sorted(rows, key=lambda kv: -kv[1])[:5]:
        print(f"hybrid {label}: device {t / 1e3:.3f} ms  {key[:100]}")
    return out


OWN_KERNEL = {"conv": "conv2d", "hist": "hist", "spmv": "spmv_ell"}


def hybrid_phase(torch, np):
    """Returns the launch counts of each main-path call ("conv cold",
    "conv warm", ...): every count is set to 0 just before the call and
    read just after it."""
    from repro_torch.core import cost_model
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels import common
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.workloads import conv, hist, spmv

    ex = HybridExecutor()
    devs = {g.name: [str(d) for d in g.devices] for g in ex.groups}
    print(f"hybrid: groups={devs} simulated={ex.simulated} "
          f"host_threads={torch.get_num_threads()}")
    if ex.simulated or devs != {"accel": ["cuda:0"], "host": ["cpu"]}:
        raise AssertionError(f"expected accel=cuda:0 host=cpu, got {devs}")

    per_call = {}

    def run(label, fn, reference, tol, forced=False, profile=False):
        common.reset_launches()
        t0 = time.perf_counter()
        out = profiled(torch, label, fn) if profile else fn()
        wall = time.perf_counter() - t0
        counts = common.launch_counts()
        print(f"hybrid {label}: launches={counts}")
        workload, kind = label.split()
        if kind in ("cold", "warm"):
            per_call[label] = counts
            if counts[OWN_KERNEL[workload]] <= 0:
                raise AssertionError(f"{label}: {OWN_KERNEL[workload]} was "
                                     f"not launched")
        if out.result.mode != "threads":
            raise AssertionError(f"{label}: mode {out.result.mode}")
        value = out.value.cpu()
        if tol == 0:
            if not torch.equal(value, reference):
                raise AssertionError(f"{label}: value differs")
        else:
            torch.testing.assert_close(value, reference, rtol=tol, atol=tol,
                                       msg=lambda m: f"{label}: {m}")
        report(label, out)
        print(f"hybrid {label}: wall_s={wall!r} value ok (tol {tol})")
        if forced and not (out.trace.group_units.get("host", 0) > 0
                           and overlap_s(out.trace) > 0):
            raise AssertionError(f"{label}: the host lane did not run "
                                 f"concurrently with the card")
        return out

    img, w = conv.make_inputs(CONV_SIZE, CONV_K)
    conv_ref = conv2d_ref(torch.tensor(img), torch.tensor(w))
    keys = hist.make_inputs(HIST_N, HIST_BINS)
    hist_ref = torch.tensor(np.bincount(keys, minlength=HIST_BINS)
                            .astype(np.int32))
    A = spmv.make_matrix(SPMV_N, SPMV_DENSITY)
    spmv_ref = torch.tensor((A.astype(np.float64)
                             @ spmv.make_vector(SPMV_N).astype(np.float64))
                            .astype(np.float32))
    print(f"hybrid: spmv at n={SPMV_N} (make_matrix builds a dense n x n "
          f"matrix on the host, so n is cut to what host memory and time "
          f"allow)")

    # each workload's cold call starts, as in a fresh process, with no
    # hardware profile: its calibration measures one (the probe kernel)
    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"conv {label}", lambda: conv.run_hybrid(
            ex, size=CONV_SIZE, ksize=CONV_K), conv_ref, TOL["conv2d"])
    run("conv profiled", lambda: conv.run_hybrid(
        ex, size=CONV_SIZE, ksize=CONV_K), conv_ref, TOL["conv2d"],
        profile=True)
    chunk = CONV_SIZE // ex.n_chunks
    run("conv forced", lambda: conv.run_hybrid(
        ex, size=CONV_SIZE, ksize=CONV_K,
        plan_override=[CONV_SIZE - 2 * chunk, 2 * chunk]),
        conv_ref, TOL["conv2d"], forced=True)

    cost_model.reset_profiles()
    for label in ("cold", "warm"):
        run(f"hist {label}", lambda: hist.run_hybrid(
            ex, n=HIST_N, n_bins=HIST_BINS), hist_ref, 0)
    run("hist profiled", lambda: hist.run_hybrid(
        ex, n=HIST_N, n_bins=HIST_BINS), hist_ref, 0, profile=True)
    run("hist forced", lambda: hist.run_hybrid(
        ex, n=HIST_N, n_bins=HIST_BINS, plan_override=[56, 8]),
        hist_ref, 0, forced=True)

    cost_model.reset_profiles()
    outs = [run(f"spmv {label}", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY), spmv_ref, 1e-4)
        for label in ("cold", "warm")]
    run("spmv profiled", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY), spmv_ref, 1e-4, profile=True)
    total = sum(outs[0].plan.units)
    run("spmv forced", lambda: spmv.run_hybrid(
        ex, n=SPMV_N, density=SPMV_DENSITY,
        plan_override=[total - total // 4, total // 4]),
        spmv_ref, 1e-4, forced=True)
    for workload in OWN_KERNEL:
        if per_call[f"{workload} cold"]["probe_add_one"] <= 0:
            raise AssertionError(f"{workload} cold: the calibration did "
                                 f"not launch probe_add_one")
    return per_call


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        fail("src/repro_torch/csrc not found beside this script: run it "
             "from a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA GPU")
    os.environ["REPRO_CALIB_CACHE"] = "0"
    sys.path.insert(0, SRC)
    from repro_torch.kernels import common

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    common.kernel_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {common.BUILD_DIR}")
    for line in common.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"build: {line.strip()}")

    dev = torch.device("cuda", 0)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    rows = kernel_phase(torch, np, dev, flush)
    del flush

    per_call = hybrid_phase(torch, np)
    # the main path: the cold and the warm call of each workload
    for r in rows:
        r["launches_per_call"] = {label: c[r["name"]]
                                  for label, c in per_call.items()}
        r["launches"] = sum(r["launches_per_call"].values())
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on the "
                                 f"main path")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
