"""Dither workload (paper §4.10, [18]): Floyd-Steinberg error diffusion.

Inherently sequential (pixel (i,j) needs errors from (i,j-1), (i-1,*)).
Correctness path: exact FSD as a wavefront — pixel (i, j) is computed
at step 2i + j, when its inputs (i, j-1) and (i-1, j-1..j+1) are done,
so the 2(H-1) + W steps are each vectorised over their pixels with the
reference's per-pixel arithmetic, in its order.  Hybrid path: the
paper's trapezoidal column split — group A dithers the left span of row
i while group B dithers the right span of row i-1, transferring at most
3 boundary error floats per row; the pipeline is modeled with the task
scheduler (pipelined parallelism).  The full dither is timed once, on
the accel group's device, and the other device class is priced as that
time x its ``slowdown``: the reference's model.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import (
    HybridExecutor, WorkSharedOutput, scheduled_output)
from repro_torch.core.task_graph import TaskGraph
from repro_torch.kernels.common import sync_device, to_device


def unit_cost_terms(h: int, w: int) -> CostTerms:
    """Prior for one FULL Floyd-Steinberg dither of an (h, w) image:
    ~10 ops per pixel (quantize + 4 error pushes), but executed as a
    sequential row scan — ``steps=h`` charges the per-row dependency
    chain so the model doesn't rank this like a data-parallel kernel.
    The request is one indivisible unit (the trapezoidal hybrid split
    lives inside ``run_hybrid``, not across serving lanes)."""
    px = float(h) * float(w)
    return CostTerms(flops=10.0 * px, bytes=8.0 * px, steps=max(h, 1))


@functools.lru_cache(maxsize=4)
def make_image(h: int = 256, w: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic numpy intensities in [0, 255) (the reference's
    generator), memoized out of timed paths."""
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) * 255).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _wavefront(h: int, w: int, device: str):
    """The wavefront's index plan on ``device``: every pixel's flat
    index in step order, and the error buffer's indices of the pixel
    itself, its left neighbour and the three above it.  The error
    buffer holds a zero row above the image and a zero column at each
    side, the reference's zero boundary errors.  Returns the index
    tensors and each step's [start, end) in them."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    step = (2 * ii + jj).ravel()
    order = np.argsort(step, kind="stable")
    i, j = ii.ravel()[order], jj.ravel()[order]
    wp = w + 2
    own = (i + 1) * wp + j + 1
    up = own - wp
    starts = np.searchsorted(step[order], np.arange(2 * (h - 1) + w + 1))
    idx = to_device((i * w + j, own, own - 1, up, up + 1, up - 1), device)
    return idx, starts.tolist()


def fsd_dither(img: torch.Tensor) -> torch.Tensor:
    """Exact Floyd-Steinberg (serpentine off), 1-bit palette, on
    ``img``'s device.  Per pixel, as the reference's scans:
    old = x + (down + left + right) + err_right, with down, left and
    right the errors the row above pushed into it (5/16, 3/16, 1/16)
    and err_right the one its left neighbour pushed (7/16)."""
    H, W = img.shape
    (pix, own, left_of, up, up_right, up_left), starts = _wavefront(
        H, W, str(img.device))
    err = torch.zeros((H + 1) * (W + 2), dtype=torch.float32,
                      device=img.device)
    out = torch.empty(H * W, dtype=torch.float32, device=img.device)
    x = img.reshape(-1)
    for lo, hi in zip(starts[:-1], starts[1:]):
        u = up[lo:hi]
        below = ((err[u] * (5 / 16) + err[up_right[lo:hi]] * (3 / 16))
                 + err[up_left[lo:hi]] * (1 / 16))
        p = pix[lo:hi]
        old = x[p] + below + err[left_of[lo:hi]] * (7 / 16)
        new = torch.where(old > 127.5, 255.0, 0.0)
        err[own[lo:hi]] = old - new
        out[p] = new
    return out.reshape(H, W)


def run_hybrid(ex: HybridExecutor, h: int = 256, w: int = 256
               ) -> WorkSharedOutput:
    dev = primary_device(ex.groups[0])
    img = to_device(make_image(h, w), dev)
    _wavefront(h, w, str(dev))               # set-up: the index plan
    # measure the full dither once, on the accel group's device
    t0 = time.perf_counter()
    out = fsd_dither(img)
    sync_device(dev)
    t_full = time.perf_counter() - t0
    slow = {g.name: g.slowdown for g in ex.groups}

    # pipelined column split sized by the throughput ratio (paper
    # §5.4.3): the accelerator takes the left span, the host the right,
    # with the paper's 3-float boundary transfer per row
    n_rows = 16                              # schedule granularity
    t_row = t_full / n_rows
    thr_a = 1.0 / slow["accel"]
    thr_h = 1.0 / slow["host"]
    frac_a = thr_a / (thr_a + thr_h)         # accel column share
    g = TaskGraph()
    for i in range(n_rows):
        deps_l = [f"L{i-1}"] if i else []
        g.add(f"L{i}", {"accel": t_row * frac_a * slow["accel"],
                        "host": t_row * frac_a * slow["host"]},
              deps=deps_l, output_bytes=3 * 4)
        deps_r = [f"L{i}"] + ([f"R{i-1}"] if i else [])
        g.add(f"R{i}", {"accel": t_row * (1 - frac_a) * slow["accel"],
                        "host": t_row * (1 - frac_a) * slow["host"]},
              deps=deps_r, output_bytes=3 * 4)
    sched = g.schedule({"accel": "accel", "host": "host"}, link_bw=6e9)
    single = {name: t_full * s for name, s in slow.items()}
    return scheduled_output(ex, "Dither", sched, single, out,
                            [n_rows, n_rows])
