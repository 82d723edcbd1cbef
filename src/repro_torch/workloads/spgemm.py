"""spgemm workload (paper §4.4): row-row method, work shared by rows.

C(i,:) = sum_{j in A(i,:)} A(i,j) * B(j,:) — only contributing elements
are touched.  The work share is derived from measured CPU/GPU-alone
runtimes (the paper's heuristic for the unpredictable output volume).

Each group packs its row block into padded ELL on the host and
computes the gathered, weighted row sum on its own device from its own
copy of B; ``combine`` gathers the row blocks onto the accel group's
device inside the executor's timed merge.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.kernels.common import sync_device, to_device


def unit_cost_terms(n: int, density: float) -> CostTerms:
    """Analytic prior for ONE output row of the row-row product.

    Each of the ~``n * density`` nonzeros in an A row gathers a dense
    B row (length n) and multiply-accumulates it into C(i,:): flops =
    2 * k * n with k the expected (padded-ELL) row width, bytes = the
    gathered B rows + the vals/idx reads + the output row write.  The
    prior only seeds placement/planning before the first measured
    execution — measurement always overwrites it."""
    k = max(n * density * 1.5, 1.0)          # 1.5x: ELL pad of the max row
    return CostTerms(flops=2.0 * k * n,
                     bytes=4.0 * (k * n + 2.0 * k + n))


@functools.lru_cache(maxsize=4)
def make_matrices(n: int = 1024, density: float = 0.02, seed: int = 0):
    """Deterministic numpy A and B (the reference's generator: the same
    seed gives bit-identical arrays), memoized out of timed paths."""
    rng = np.random.default_rng(seed)
    A = ((rng.random((n, n)) < density)
         * rng.standard_normal((n, n))).astype(np.float32)
    B = ((rng.random((n, n)) < density)
         * rng.standard_normal((n, n))).astype(np.float32)
    return A, B


@functools.lru_cache(maxsize=4)
def _placed_b(n: int, density: float, seed: int, device: str):
    return to_device(make_matrices(n, density, seed)[1], device)


def pack_rows(A_block: np.ndarray):
    """Padded-ELL packing of a row block on the host: per row its
    nonzero values and their columns, in column order, padded with
    zeros to the block's widest row (the reference's per-row loop,
    vectorised: the same arrays)."""
    nz = A_block != 0
    counts = nz.sum(1)
    K = max(int(counts.max()) if counts.size else 0, 1)
    R = A_block.shape[0]
    vals = np.zeros((R, K), np.float32)
    idx = np.zeros((R, K), np.int64)
    rows, cols = np.nonzero(nz)               # row-major: columns ascend
    pos = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    vals[rows, pos] = A_block[rows, cols]
    idx[rows, pos] = cols
    return vals, idx


def rowrow(A_block: np.ndarray, B: torch.Tensor) -> torch.Tensor:
    """Row-row product of a (padded-ELL) row block with sparse B, on
    B's device."""
    vals, idx = pack_rows(A_block)
    v = torch.from_numpy(vals).to(B.device)
    i = torch.from_numpy(idx).to(B.device)
    # C(i,:) = sum_k vals[i,k] * B[idx[i,k], :]   (gather + weighted sum)
    return torch.einsum("rk,rkc->rc", v, B[i])


def run_hybrid(ex: HybridExecutor, n: int = 1024, density: float = 0.02
               ) -> WorkSharedOutput:
    A, _ = make_matrices(n, density)
    placed = {g.name: _placed_b(n, density, 0, str(primary_device(g)))
              for g in ex.groups}
    dest = primary_device(ex.groups[0])

    def run_share(group, start, k):
        B = placed[group]
        out = rowrow(A[start:start + k], B)
        sync_device(B.device)
        return out

    def combine(outs):
        value = torch.cat([o.to(dest) for o in outs], dim=0)
        sync_device(dest)
        return value

    # cost prior: a cold cache plans row shares from the analytic
    # row-row terms with zero probe runs
    ex.calibrate(lambda g, k: run_share(g, 0, k), probe_units=n // 8,
                 workload=f"spgemm/{n}x{density}",
                 unit_cost=unit_cost_terms(n, density))
    comm = n * n * density * 8 / 6e9           # C shares back
    return ex.run_work_shared("spgemm", n, run_share, combine,
                              comm_cost=comm)
