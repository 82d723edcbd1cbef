"""Conv workload (paper §4.6): regular, compute-bound, work-shared rows.

The paper starts from a ~25% CPU share (the 3x GPU:CPU ratio of Lee et
al.) and tunes empirically; Fig. 4 shows an 18% split on a 3600x3600
image with a 15x15 filter.  Here the split comes from calibrated
throughput and the halo rows are the only communication (K-1 rows).

Each group convolves its rows from its own copy of the inputs on its
own device with the autotuned config of that device (on the real pair
the GPU group's and the CPU group's winners are searched apart, at the
shape of one chunk with its halo; with the search off, the CUDA kernel
and the shift-add peer); ``combine`` gathers the row blocks onto the
accel group's device inside the executor's timed merge.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.kernels.common import sync_device, to_device
from repro_torch.kernels.conv2d.ops import conv2d, tuned_config
from repro_torch.workloads import tuned_per_device


@functools.lru_cache(maxsize=8)
def make_inputs(size: int = 512, ksize: int = 15, seed: int = 0):
    """Deterministic numpy inputs (the reference's generator: the same
    seed gives bit-identical arrays), memoized out of timed paths."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((size, size)).astype(np.float32)
    w = rng.standard_normal((ksize, ksize)).astype(np.float32)
    return img, w


@functools.lru_cache(maxsize=4)
def _placed(size: int, ksize: int, seed: int, device: str):
    return to_device(make_inputs(size, ksize, seed), device)


def conv_rows(img: torch.Tensor, w: torch.Tensor, start: int, n: int,
              config=None) -> torch.Tensor:
    """Convolve rows [start, start+n) with halo (the share kernel)."""
    K = w.shape[0]
    r = K // 2
    lo = max(0, start - r)
    hi = min(img.shape[0], start + n + r)
    out = conv2d(img[lo:hi], w, config=config)
    return out[start - lo:start - lo + n]


def run_hybrid(ex: HybridExecutor, size: int = 512, ksize: int = 15,
               plan_override=None, sequential: bool = False
               ) -> WorkSharedOutput:
    placed = {g.name: _placed(size, ksize, 0, str(primary_device(g)))
              for g in ex.groups}
    dest = primary_device(ex.groups[0])
    # each device's winner at the shape of one chunk with its halo rows
    rows = min(size, max(size // ex.n_chunks, 1) + ksize - 1)
    cfgs = tuned_per_device(placed, lambda p: tuned_config(p[0][:rows],
                                                           p[1]))

    def run_share(group, start, n):
        img, w = placed[group]
        out = conv_rows(img, w, start, n, config=cfgs[group])
        sync_device(img.device)
        return out

    def combine(outs):
        value = torch.cat([o.to(dest) for o in outs], dim=0)
        sync_device(dest)
        return value

    # cost of ONE work unit (an output row): a cold cache plans from
    # this model prediction with zero probe runs; a warm (possibly
    # disk-persisted) cache plans from measured unit times
    unit_cost = CostTerms(flops=2.0 * size * ksize * ksize,
                          bytes=4.0 * 2 * size)
    ex.calibrate(lambda g, n: run_share(g, 0, n),
                 probe_units=max(size // 8, 1),
                 workload=f"Conv/{size}x{ksize}", unit_cost=unit_cost)
    comm = (ksize - 1) * size * 4 / 6e9       # halo rows over the link
    return ex.run_work_shared(
        "Conv", size, run_share, combine, comm_cost=comm,
        plan_override=plan_override, sequential=sequential)


def run_hybrid_with_split(ex: HybridExecutor, units, size: int = 512,
                          ksize: int = 15) -> WorkSharedOutput:
    """Force an exact [accel, host] unit split (split-sweep benchmark).
    Only ``run_hybrid``'s ``plan_override``, which also turns stealing
    off; kept under the reference's name, which split_sweep calls."""
    return run_hybrid(ex, size=size, ksize=ksize, plan_override=list(units))
