"""Per-kernel microbenchmarks: the autotuned config against the route's
default.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench

Each row times one kernel's public ``ops`` entry at the config the
per-backend tune cache picked for this shape bucket
(``kernels/autotune.py``) and reports, in the derived column, that
config plus its speedup over the no-search default
(``autotune.default_config``: the route's hand-written CUDA kernel on a
GPU, the CPU peer on the CPU).  On the GPU a call is timed with CUDA
events around a run of calls; on the CPU with the host clock (a CPU
time, never a device one).  The shapes are the reference's
``benchmarks/kernels_bench.py``.

Config resolution happens *before* timing: the first run pays the
search and writes the tune file; the next is a pure cache hit, so the
timed path never contains a search.  ``run(device="cpu")`` runs on the
CPU; the default is the first GPU, and raises without one.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels.autotune import default_config
from repro_torch.kernels.common import resolve_device


def _t(fn, dev: torch.device, iters: int = 7) -> float:
    """us per call, min-of-N (the trajectory gate, ``regress.py``,
    compares runs; the minimum is the stable estimator of a kernel's
    achievable time).  Sub-millisecond calls get more reps.  On a GPU
    each rep is a CUDA-event interval around one call."""
    fn()
    fn()
    best = float("inf")
    done = 0
    while done < iters:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        done += 1
        if done == iters and best < 1e-3 and iters < 50:
            iters = 50
    return best * 1e6


def _fmt_cfg(cfg: dict) -> str:
    return ";".join(f"{k}={v}" for k, v in sorted(cfg.items()))


def _row(name: str, tuned_us: float, default_us: float, cfg: dict,
         extra: str) -> str:
    speed = default_us / max(tuned_us, 1e-9)
    row = (f"kernels/{name},{tuned_us:.0f},{extra}|cfg={_fmt_cfg(cfg)}"
           f"|default_us={default_us:.0f}|vs_default={speed:.2f}x")
    print(row)
    return row


def run(device=None):
    """One row per kernel (hist, attention, gmm, conv, spmv, sort) on
    ``device``; returns the rows."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    rows = []

    def bench(name, ops, tuned_cfg, call, extra):
        default = default_config(ops.DEFAULT_CONFIG, ops.CPU_CONFIG, dev)
        tuned = _t(lambda: call(tuned_cfg), dev)
        base = _t(lambda: call(default), dev)
        rows.append(_row(name, tuned, base, tuned_cfg, extra))

    # ----------------------------------------------------------- hist
    from repro_torch.kernels.hist import ops as hist_ops
    x = torch.randint(0, 256, (1 << 20,), generator=gen,
                      dtype=torch.int32).to(dev)
    bench("hist_1M", hist_ops, hist_ops.tuned_config(x, 256),
          lambda c: hist_ops.histogram(x, 256, config=c), "bins=256")

    # ------------------------------------------------ flash attention
    from repro_torch.kernels.flash_attention import ops as attn_ops
    q = randn(1, 1024, 8, 64, dtype=torch.bfloat16)
    k = randn(1, 1024, 2, 64, dtype=torch.bfloat16)
    v = randn(1, 1024, 2, 64, dtype=torch.bfloat16)
    bench("attn_1k", attn_ops, attn_ops.tuned_config(q, k, v),
          lambda c: attn_ops.flash_attention(q, k, v, config=c),
          "B1_T1024_H8_GQA")

    # ------------------------------------------------------------ gmm
    from repro_torch.kernels.gmm import ops as gmm_ops
    xe = randn(8, 256, 256, dtype=torch.bfloat16)
    we = randn(8, 256, 512, dtype=torch.bfloat16)
    bench("gmm_8x256", gmm_ops, gmm_ops.tuned_config(xe, we),
          lambda c: gmm_ops.gmm(xe, we, config=c), "E8_C256_D256_F512")

    # ----------------------------------------------------------- conv
    from repro_torch.kernels.conv2d import ops as conv_ops
    img = randn(512, 512)
    w = randn(15, 15)
    bench("conv_512", conv_ops, conv_ops.tuned_config(img, w),
          lambda c: conv_ops.conv2d(img, w, config=c), "15x15")

    # ----------------------------------------------------------- spmv
    from repro_torch.kernels.spmv import ops as spmv_ops
    vals = randn(4096, 32)
    idx = torch.randint(0, 4096, (4096, 32), generator=gen,
                        dtype=torch.int32).to(dev)
    xv = randn(4096)
    bench("spmv_4k", spmv_ops, spmv_ops.tuned_config(vals, idx, xv),
          lambda c: spmv_ops.spmv_ell(vals, idx, xv, config=c), "ELL_K32")

    # ----------------------------------------------------------- sort
    from repro_torch.kernels.sort_bitonic import ops as sort_ops
    s = randn(256, 1024)
    bench("sort_256x1k", sort_ops, sort_ops.tuned_config(s),
          lambda c: sort_ops.sort_rows(s, config=c), "rows")
    return rows


if __name__ == "__main__":
    run()
