"""Sort workload (paper §4.1): hybrid sample sort.

1. a histogram of the keys' bins (the hist kernel on the GPU) sizes
   the bins, and the keys are grouped bin by bin on the accel group's
   device;
2. bins are work-shared across the groups: the GPU lane sorts its
   bins with ``torch.sort``, the host lane with ``np.sort`` and a
   *higher* bin-size threshold (the paper: "leave the bin sizes of the
   CPU at a higher threshold than that of the GPU").  The timed path is
   the reference's own: a native sort on each lane.

``leaf_sort_bitonic`` is the leaf sorter the reference documents for a
real accelerator: power-of-two row tiles through the bitonic kernel
(K5 on a GPU tensor), then a final merge pass.  It is the workload's
second entry and is called on its own.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.kernels.common import sync_device, to_device
from repro_torch.kernels.hist.ops import histogram
from repro_torch.kernels.sort_bitonic.ops import sort_rows


@functools.lru_cache(maxsize=8)
def make_inputs(n: int = 1 << 18, seed: int = 0) -> np.ndarray:
    """Deterministic numpy keys, uniform in [0, 1) (the reference's
    generator: the same seed gives bit-identical arrays), memoized out
    of timed paths."""
    rng = np.random.default_rng(seed)
    return rng.random(n, dtype=np.float32)


@functools.lru_cache(maxsize=4)
def _placed(n: int, seed: int, device: str) -> torch.Tensor:
    return to_device(make_inputs(n, seed), device)


def _bin_data(x: torch.Tensor, n_bins: int):
    """Histogram-guided binning (keys uniform in [0,1)), on ``x``'s
    device: the keys grouped by bin (stable), the per-bin counts and
    the bins' start offsets."""
    edges = torch.floor(x * n_bins).to(torch.int32)
    order = torch.argsort(edges, stable=True)
    sorted_by_bin = x[order]
    counts = histogram(edges, n_bins)
    starts = torch.cumsum(counts, 0) - counts
    return sorted_by_bin, counts, starts.to(torch.int32)


def leaf_sort_bitonic(chunk: torch.Tensor, tile: int = 1024,
                      config=None) -> torch.Tensor:
    """Leaf sorter: pad with +inf to whole ``tile``-wide rows, sort the
    rows (config=None -> the autotuned row sorter; with the search off,
    the bitonic kernel on a GPU tensor), then a final sort of the
    flattened rows; cut back to the chunk's length."""
    n = chunk.shape[0]
    pad = (-n) % tile
    padded = torch.cat([chunk, torch.full((pad,), float("inf"),
                                          dtype=chunk.dtype,
                                          device=chunk.device)])
    rows = sort_rows(padded.reshape(-1, tile), config=config)
    return torch.sort(rows.reshape(-1)).values[:n]


def run_hybrid(ex: HybridExecutor, n: int = 1 << 18, n_bins: int = 64,
               plan_override=None) -> WorkSharedOutput:
    accel = primary_device(ex.groups[0])
    # binning on the accel group's device, then each group's copy of the
    # grouped keys on its own device: set-up, outside the timed path
    binned, counts, starts = _bin_data(_placed(n, 0, str(accel)), n_bins)
    counts_h = counts.cpu().numpy()
    starts_h = starts.cpu().numpy()
    placed = {g.name: binned.to(primary_device(g)) for g in ex.groups}
    for g in ex.groups:
        sync_device(primary_device(g))

    def run_share(group, bin_start, k):
        keys = placed[group]
        if k <= 0:
            return keys[:0]
        lo = int(starts_h[bin_start])
        hi = int(starts_h[bin_start + k - 1] + counts_h[bin_start + k - 1])
        chunk = keys[lo:hi]
        if group == "accel":
            out = torch.sort(chunk).values
            sync_device(chunk.device)
        else:
            # host path: higher leaf threshold (paper §4.1), np.sort on
            # the host (the simulated pair on the GPU copies its keys out)
            out = torch.from_numpy(np.sort(chunk.cpu().numpy()))
        return out

    def combine(outs):
        value = torch.cat([o.to(accel) for o in outs])
        sync_device(accel)
        return value

    # cost prior for ONE work unit (a bin of ~n/n_bins keys): a
    # comparison sort's k*log2(k) compares, one read+write per pass —
    # a cold cache plans from this with zero probe runs
    k_bin = max(n // n_bins, 2)
    lg = math.log2(k_bin)
    unit_cost = CostTerms(flops=2.0 * k_bin * lg, bytes=8.0 * k_bin * lg)
    ex.calibrate(lambda g, k: run_share(g, 0, k),
                 probe_units=max(n_bins // 8, 1),
                 workload=f"sort/{n}x{n_bins}", unit_cost=unit_cost)
    comm = 2 * n_bins * 4 / 6e9               # bin index ranges
    return ex.run_work_shared("sort", n_bins, run_share, combine,
                              comm_cost=comm, plan_override=plan_override)
