"""spmv workload (paper §4.3): the flagship work-sharing-by-suitability.

Rows are sorted by nnz; *dense* rows go to the accelerator (ELL kernel),
the *sparse tail* goes to the host path (COO segment-sum).  The split
threshold is exactly the work-share knob; the x vector is kept on both
devices (paper: "the entire x vector is kept at both the CPU and GPU").
Each share's packing lives on its group's device; ``combine`` scatters
the partial results back into row order on the accel group's device
inside the executor's timed merge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.kernels.common import sync_device, to_device
from repro_torch.kernels.spmv import ops as spmv_ops


def make_matrix(n: int = 2048, density: float = 0.01, seed: int = 0,
                skew: float = 4.0) -> np.ndarray:
    """Power-law row densities (like the paper's [49] suite); dense
    numpy, the reference's generator."""
    rng = np.random.default_rng(seed)
    base = rng.random((n, n)) < density
    heavy = rng.choice(n, max(n // 50, 1), replace=False)
    base[heavy] |= rng.random((len(heavy), n)) < density * skew * 10
    A = base.astype(np.float32) * rng.standard_normal((n, n)).astype(
        np.float32)
    return A


def make_vector(n: int = 2048, seed: int = 0) -> np.ndarray:
    """The x of ``make_share_spec`` (the reference's generator)."""
    return np.random.default_rng(seed + 1).standard_normal(n).astype(
        np.float32)


# ELL/COO packing is the paper's amortized preprocessing ("spmv is
# used over multiple iterations") — kept across calls, per device
# (matrices are deterministic per (n, density, seed)), so steady-state
# shares never pay packing inside the timed path
_PREP_CACHE = {}


@dataclass(frozen=True)
class ShareSpec:
    """The work-shared form of one spmv problem."""
    total_units: int
    run_share: Callable[[str, int, int], object]
    combine: Callable[[list], object]
    unit_cost: Dict[str, CostTerms]
    comm_cost: float
    workload: str


def _per_path_unit_cost(unit: int) -> Dict[str, CostTerms]:
    """Per-path cost priors for ONE work unit (``unit`` nonzeros): the
    groups run *different algorithms*, so a single CostTerms cannot
    seed both.  ELL head (accel): vals+idx reads, x gather, padded-row
    waste folded into a 1.5x byte factor (power-law heads pad the tile
    width).  COO tail (host): rows+cols+vals reads, x gather, and the
    segment-sum's y read-modify-write."""
    return {
        "accel": CostTerms(flops=2.0 * unit, bytes=4.0 * 3.0 * unit * 1.5),
        "host": CostTerms(flops=2.0 * unit, bytes=4.0 * 5.0 * unit),
    }


def make_share_spec(devices: Dict[str, torch.device], dest: torch.device,
                    n: int = 2048, density: float = 0.01, seed: int = 0
                    ) -> ShareSpec:
    """Build the suitability-split execution (paper §4.3): rows sorted
    by nnz, dense prefix -> ELL on the accel group, sparse tail -> COO
    on the host group; work units are nonzero blocks.  ``devices`` maps
    each group to its device, ``dest`` is where ``combine`` gathers."""
    A = make_matrix(n, density, seed)
    x_np = make_vector(n, seed)
    xs = {name: to_device(x_np, dev) for name, dev in devices.items()}
    nnz = (A != 0).sum(1)
    # paper: sort rows by nnz; DENSE prefix -> accelerator (group 0),
    # sparse tail -> host (group 1)
    order = np.argsort(-nnz)
    order_t = to_device(order.astype(np.int64), dest)
    A_sorted = A[order]
    # Work units are NONZEROS, not rows: per-row cost is wildly
    # non-uniform after the density sort, per-nnz cost is uniform.
    cum_nnz = np.concatenate([[0], np.cumsum(nnz[order])])
    total_nnz = int(cum_nnz[-1])
    unit = max(total_nnz // 256, 1)
    total_units = total_nnz // unit

    def rows_of(start_u, k_u):
        lo = int(np.searchsorted(cum_nnz, start_u * unit, side="left"))
        if start_u + k_u >= total_units:        # last share covers the rest
            return min(lo, n - 1), n
        hi = int(np.searchsorted(cum_nnz, (start_u + k_u) * unit,
                                 side="left"))
        return lo, max(hi, lo + 1)

    def run_share(group, start_u, k_u):
        lo, hi = rows_of(start_u, k_u)
        dev = devices[group]
        key = (n, density, seed, group, lo, hi, str(dev))
        if key not in _PREP_CACHE:
            block = A_sorted[lo:hi]
            if group == "accel":
                # dense rows -> ELL kernel, binned in row TILES so the
                # power-law head doesn't set the padding width for the
                # whole share (the paper's row binning, per 512 rows)
                tiles = []
                for t0 in range(0, block.shape[0], 512):
                    sub = block[t0:t0 + 512]
                    tiles.append(spmv_ops.prepare(
                        sub, k_threshold=int(max((sub != 0).sum(1).max(),
                                                 1)), device=dev))
                _PREP_CACHE[key] = tiles
            else:                               # sparse tail -> COO path
                rr, cc = np.nonzero(block)
                _PREP_CACHE[key] = to_device(
                    (rr.astype(np.int32), cc.astype(np.int32),
                     block[rr, cc]), dev)
        x = xs[group]
        if group == "accel":
            y = torch.cat([spmv_ops.spmv(m_, x) for m_ in _PREP_CACHE[key]])
        else:
            rr, cc, vv = _PREP_CACHE[key]
            y = spmv_ops.spmv_coo(rr, cc, vv, x, hi - lo)
        sync_device(dev)
        return (lo, hi, y)

    def combine(outs):
        y = torch.zeros(n, dtype=torch.float32, device=dest)
        for lo, hi, part in outs:
            y[order_t[lo:hi]] = part.to(dest)   # undo row permutation
        sync_device(dest)
        return y

    return ShareSpec(total_units=total_units, run_share=run_share,
                     combine=combine,
                     unit_cost=_per_path_unit_cost(unit),
                     comm_cost=n * 4 / 6e9,          # y merge
                     workload=f"spmv/{n}x{density}")


def run_hybrid(ex: HybridExecutor, n: int = 2048, density: float = 0.01,
               plan_override=None) -> WorkSharedOutput:
    devices = {g.name: primary_device(g) for g in ex.groups}
    spec = make_share_spec(devices, primary_device(ex.groups[0]), n,
                           density)
    # per-path cost priors: a cold cache plans the ELL head and COO
    # tail from their own analytic terms with zero probe runs
    ex.calibrate(lambda g, k: spec.run_share(g, 0, k),
                 probe_units=spec.total_units // 8,
                 workload=spec.workload, unit_cost=spec.unit_cost)
    # suitability split (dense head -> ELL, sparse tail -> COO): each
    # share runs as ONE chunk (no stealing) — ELL/COO shapes are
    # data-dependent per row range, so a uniform chunk grid would make
    # every chunk a fresh packing inside the timed path
    return ex.run_work_shared("spmv", spec.total_units, spec.run_share,
                              spec.combine, comm_cost=spec.comm_cost,
                              whole_shares=True, plan_override=plan_override)
