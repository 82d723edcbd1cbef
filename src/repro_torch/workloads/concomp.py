"""Connected components workload (paper §4.8): graph-partition hybrid.

The paper partitions V into V1 (BFS on the CPU — DFS/BFS is the best
sequential technique) and V2 (Shiloach-Vishkin-style on the GPU), then
merges components over the cross edges.  Here: host path = numpy BFS,
accelerator path = torch min-label propagation on the accel group's
device, merge = union-find on the host.  The |V1| split point is the
work-share knob.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput


def unit_cost_terms(n: int, avg_deg: float = 4.0) -> Dict[str, CostTerms]:
    """Per-path priors for ONE vertex of a subgraph share: the groups
    run *different algorithms* (paper §4.8), so a single CostTerms
    cannot seed both.  Accel: min-label propagation, ~log2(n) rounds of
    per-edge gathers + pointer jumps.  Host: python/numpy BFS — its
    cost is interpreter overhead per adjacency visit, modeled as host
    traffic so it rates at the measured host-callback bandwidth rather
    than the streaming-flops peak no interpreter loop can reach."""
    rounds = max(float(np.log2(max(n, 2))), 1.0)
    return {
        "accel": CostTerms(flops=4.0 * avg_deg * rounds,
                           bytes=8.0 * (avg_deg + 2.0) * rounds),
        "host": CostTerms(flops=2.0 * avg_deg,
                          host_bytes=1500.0 * (1.0 + avg_deg)),
    }


@functools.lru_cache(maxsize=4)
def make_graph(n: int = 1 << 14, avg_deg: float = 4.0, seed: int = 0):
    """Random undirected edges as a numpy (m, 2) array (the reference's
    generator), memoized out of timed paths.  Returns (n, edges)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    keep = u != v
    return n, np.stack([u[keep], v[keep]], 1)


def bfs_components_np(n: int, edges: np.ndarray) -> np.ndarray:
    """Host path: BFS labeling."""
    adj_idx = [[] for _ in range(n)]
    for a, b in edges:
        adj_idx[a].append(b)
        adj_idx[b].append(a)
    label = -np.ones(n, np.int64)
    for s in range(n):
        if label[s] >= 0:
            continue
        label[s] = s
        stack = [s]
        while stack:
            x = stack.pop()
            for y in adj_idx[x]:
                if label[y] < 0:
                    label[y] = s
                    stack.append(y)
    return label


def label_prop_components(n_nodes: int, edges: torch.Tensor
                          ) -> torch.Tensor:
    """Accelerator path: iterative min-label propagation (SV-style) on
    ``edges``' device; the reference's ``while_loop``, one host sync an
    iteration to test for the fixed point."""
    u, v = edges[:, 0], edges[:, 1]
    label = torch.arange(n_nodes, device=edges.device)
    while True:
        mn = torch.minimum(label[u], label[v])
        new = label.clone()
        new.scatter_reduce_(0, u, mn, reduce="amin")
        new.scatter_reduce_(0, v, mn, reduce="amin")
        # pointer-jump to representatives (hooking + shortcutting)
        new = new[new]
        if not bool((new != label).any()):
            return new
        label = new


class _UF:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


@dataclass(frozen=True)
class ShareSpec:
    """The work-shared form of one concomp problem, reusable by both
    ``run_hybrid`` and the serving request adapter (per-subgraph
    shares: units are vertices of a contiguous vertex range)."""
    total_units: int
    run_share: Callable[[str, int, int], object]
    combine: Callable[[list], object]
    unit_cost: Dict[str, CostTerms]
    comm_cost: float
    workload: str


def make_share_spec(devices: Dict[str, torch.device], n: int = 1 << 13,
                    avg_deg: float = 4.0, seed: int = 0) -> ShareSpec:
    """``devices`` maps each group name to its device: the ``host``
    group labels its subgraph with the numpy BFS, any other group with
    label propagation on its device."""
    n, edges = make_graph(n, avg_deg, seed)

    def run_share(group, start, k):
        """Label the induced subgraph on vertices [start, start+k)."""
        lo, hi = start, start + k
        mask = ((edges[:, 0] >= lo) & (edges[:, 0] < hi)
                & (edges[:, 1] >= lo) & (edges[:, 1] < hi))
        sub = edges[mask] - lo
        if group == "host":
            lab = bfs_components_np(k, sub) + lo
        elif len(sub) == 0:
            lab = np.arange(k) + lo
        else:
            lab = label_prop_components(
                k, torch.from_numpy(sub).to(devices[group])
            ).cpu().numpy() + lo
        return lab

    def combine(outs):
        """Merge via the contracted cross-edge graph: union-find runs
        over component *labels* only (cheap), not all vertices —
        the paper runs this final step on the GPU for the same reason.
        Works for any number of contiguous chunks: an edge is a cross
        edge when its endpoints were labeled by different chunks."""
        label = np.concatenate(outs).astype(np.int64)
        cuts = np.cumsum([np.asarray(o).shape[0] for o in outs])[:-1]

        def piece(v):
            return np.searchsorted(cuts, v, side="right")
        cross = edges[piece(edges[:, 0]) != piece(edges[:, 1])]
        uniq, inv = np.unique(label, return_inverse=True)
        uf = _UF(len(uniq))
        la = inv[cross[:, 0]]
        lb = inv[cross[:, 1]]
        for a, b in zip(la, lb):
            uf.union(int(a), int(b))
        root = np.asarray([uf.find(i) for i in range(len(uniq))])
        return uniq[root][inv]

    return ShareSpec(total_units=n, run_share=run_share, combine=combine,
                     unit_cost=unit_cost_terms(n, avg_deg),
                     comm_cost=len(edges) * 8 / 6e9,
                     workload=f"CC/{n}")


def run_hybrid(ex: HybridExecutor, n: int = 1 << 13, avg_deg: float = 4.0
               ) -> WorkSharedOutput:
    spec = make_share_spec({g.name: primary_device(g) for g in ex.groups},
                           n, avg_deg)
    # per-path cost priors: BFS and label-prop are different
    # algorithms, so each group's share is seeded from its own analytic
    # terms — a cold cache plans with zero probe runs
    ex.calibrate(lambda g, k: spec.run_share(g, 0, k),
                 probe_units=spec.total_units // 8,
                 workload=spec.workload, unit_cost=spec.unit_cost)
    # each share's induced subgraph has a data-dependent edge count, so
    # the shares run as single whole chunks
    return ex.run_work_shared("CC", spec.total_units, spec.run_share,
                              spec.combine, comm_cost=spec.comm_cost,
                              whole_shares=True)
