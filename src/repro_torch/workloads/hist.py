"""Hist workload (paper §4.2): memory-bound, atomics, work-shared.

Data is split between the groups, each computes a partial histogram
from its own copy of the keys with the autotuned config of its device
(searched apart on the real pair, at the size of one chunk; with the
search off, shared-memory atomics on the GPU, bincount on the CPU), and
the partials merge bin by bin on the accel group's device — the
paper's §4.2 verbatim.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.kernels.common import sync_device, to_device
from repro_torch.kernels.hist.ops import histogram, tuned_config
from repro_torch.workloads import tuned_per_device


@functools.lru_cache(maxsize=8)
def make_inputs(n: int = 1 << 20, n_bins: int = 256, seed: int = 0):
    """Deterministic numpy keys (the reference's generator), memoized
    out of timed paths."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_bins, n, dtype=np.int32)


@functools.lru_cache(maxsize=4)
def _placed(n: int, n_bins: int, seed: int, device: str):
    return to_device(make_inputs(n, n_bins, seed), device)


def run_hybrid(ex: HybridExecutor, n: int = 1 << 20, n_bins: int = 256,
               unit: int = 0, plan_override=None) -> WorkSharedOutput:
    unit = unit or max(n // 64, 1)
    units = n // unit
    placed = {g.name: _placed(n, n_bins, 0, str(primary_device(g)))
              for g in ex.groups}
    dest = primary_device(ex.groups[0])
    # each device's winner at the size of one chunk's keys
    chunk = max(units // ex.n_chunks, 1) * unit
    cfgs = tuned_per_device(placed,
                            lambda x: tuned_config(x[:chunk], n_bins))

    def run_share(group, start, k):
        x = placed[group]
        if k <= 0:
            return torch.zeros(n_bins, dtype=torch.int32, device=x.device)
        out = histogram(x[start * unit:(start + k) * unit], n_bins,
                        config=cfgs[group])
        sync_device(x.device)
        return out

    def combine(outs):                        # bin-by-bin merge
        value = torch.zeros(n_bins, dtype=torch.int32, device=dest)
        for o in outs:
            value += o.to(dest)
        sync_device(dest)
        return value

    # ONE work unit = ``unit`` elements binned; a cold cache plans from
    # the model with zero probe runs (memory-bound: bytes dominate)
    unit_cost = CostTerms(flops=2.0 * unit, bytes=4.0 * unit)
    ex.calibrate(lambda g, k: run_share(g, 0, k),
                 probe_units=max(units // 8, 1),
                 workload=f"hist/{n}x{n_bins}", unit_cost=unit_cost)
    comm = n_bins * 4 / 6e9
    return ex.run_work_shared("hist", units, run_share, combine,
                              comm_cost=comm, plan_override=plan_override)
