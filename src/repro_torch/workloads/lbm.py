"""LBM workload (paper §4.9): D3Q19 lattice Boltzmann, task parallel.

The paper assigns 4 of the 19 distribution functions to the CPU and 15
to the GPU (task parallelism over speed planes).  One BGK step =
collide (local, data-parallel) + stream (shift each plane along its
lattice velocity).  Hybrid split: plane ranges per group; after each
step the partial moments are exchanged (the communication the paper
must hide).

Each group holds its own planes on its own device: per step it sums
their partial moments there, the partials meet on the accel group's
device, and the global density and velocity go back to every group,
which collides and streams its planes.  The final state is gathered
onto the accel group's device.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch.core import work_sharing
from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import (
    HybridExecutor, WorkSharedOutput, untraced_output)
from repro_torch.kernels.common import sync_device, to_device


def unit_cost_terms(d: int, n_steps: int = 4) -> CostTerms:
    """Prior for one FULL request of ``n_steps`` BGK steps on a d^3
    lattice: per cell per step, 19 distributions pay moments (~2 ops),
    equilibrium (~8 ops) and relax+stream (~3 ops + the roll's
    read/write); steps are sequential so the request is one unit."""
    cells = float(d) ** 3
    return CostTerms(flops=19.0 * 13.0 * cells * n_steps,
                     bytes=19.0 * 4.0 * 3.0 * cells * n_steps,
                     steps=n_steps)


# D3Q19 velocities and weights
C = np.array(
    [[0, 0, 0]]
    + [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    + [[1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
       [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
       [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1]], np.int32)
W = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12, np.float32)
OMEGA = 1.2


@functools.lru_cache(maxsize=4)
def init_state(d: int = 32, seed: int = 0) -> np.ndarray:
    """Deterministic numpy (19, d, d, d) distributions (the reference's
    generator), memoized out of timed paths."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.05 * rng.standard_normal((d, d, d)).astype(np.float32)
    return W[:, None, None, None] * rho[None]


@functools.lru_cache(maxsize=8)
def _lattice(device: str):
    return to_device((C.astype(np.float32), W), device)


def moments(f: torch.Tensor):
    rho = torch.sum(f, dim=0)
    cs = _lattice(str(f.device))[0]
    u = torch.einsum("qxyz,qi->ixyz", f, cs) / torch.clamp_min(
        rho, 1e-9)[None]
    return rho, u


def equilibrium(rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    cs, w = _lattice(str(rho.device))
    cu = torch.einsum("qi,ixyz->qxyz", cs, u)
    uu = torch.sum(u * u, dim=0)[None]
    return w[:, None, None, None] * rho[None] * (
        1 + 3 * cu + 4.5 * cu ** 2 - 1.5 * uu)


def collide_planes(f, feq, qs):
    """BGK relaxation on a subset of speed planes (one group's task)."""
    return f[qs] + OMEGA * (feq[qs] - f[qs])


def _stream_planes(planes: torch.Tensor, q_ids) -> torch.Tensor:
    """Shift each plane along its lattice velocity (static plane set)."""
    return torch.stack([torch.roll(planes[i], shifts=tuple(
        int(c) for c in C[q]), dims=(0, 1, 2)) for i, q in enumerate(q_ids)])


def stream(f: torch.Tensor) -> torch.Tensor:
    return _stream_planes(f, range(19))


def step_all(f: torch.Tensor) -> torch.Tensor:
    """One single-device BGK step over all 19 planes (the serving
    adapter's dedicated path; algebraically the hybrid step with every
    plane in one group)."""
    rho, u = moments(f)
    feq = equilibrium(rho, u)
    return stream(f + OMEGA * (feq - f))


def _partial_moments(planes: torch.Tensor, q_ids):
    """Partial (rho, momentum) sums over one group's planes only —
    the per-step 4-fields-per-cell exchange of the hybrid scheme."""
    rho_p = torch.sum(planes, dim=0)
    cs = _lattice(str(planes.device))[0][list(q_ids)]
    mom_p = torch.einsum("qxyz,qi->ixyz", planes, cs)
    return rho_p, mom_p


def _collide_stream(planes: torch.Tensor, rho, u, q_ids) -> torch.Tensor:
    """Collide and stream one group's planes: the reference's
    ``_collide_stream(f, rho, u, q_ids)`` with ``f[q_ids]`` given."""
    feq = equilibrium(rho, u)[list(q_ids)]
    return _stream_planes(planes + OMEGA * (feq - planes), q_ids)


def run_hybrid(ex: HybridExecutor, d: int = 32, n_steps: int = 4
               ) -> WorkSharedOutput:
    """Task-parallel plane split with partial-moment exchange.

    Per step, each group computes partial moments over its own planes
    (timed per group), partials are exchanged and summed, then each
    group collides+streams its planes.  hybrid step time =
    max(group times) + exchange."""
    dest = primary_device(ex.groups[0])
    devs = {g.name: primary_device(g) for g in ex.groups}
    f_np = init_state(d)
    # plane shares from throughput ratio (paper: 15 GPU / 4 CPU)
    thr = [1.0 / g.slowdown for g in ex.groups]
    units = work_sharing.integer_shares(19, thr, min_units=1)
    qsets = []
    s = 0
    for k in units:
        qsets.append(tuple(range(s, s + k)))
        s += k
    own0 = {g.name: to_device(f_np[list(qs)], devs[g.name])
            for g, qs in zip(ex.groups, qsets)}

    def one_joint_step(own):
        times = {g.name: 0.0 for g in ex.groups}
        partials = []
        for g, qs in zip(ex.groups, qsets):
            dev = devs[g.name]
            t0 = time.perf_counter()
            rho_p, mom_p = _partial_moments(own[g.name], qs)
            sync_device(dev)
            times[g.name] += (time.perf_counter() - t0) * g.slowdown
            partials.append((rho_p.to(dest), mom_p.to(dest)))
        rho = sum(p[0] for p in partials)
        mom = sum(p[1] for p in partials)
        u = mom / torch.clamp_min(rho, 1e-9)[None]
        new = {}
        for g, qs in zip(ex.groups, qsets):
            dev = devs[g.name]
            rho_g, u_g = rho.to(dev), u.to(dev)
            sync_device(dest)
            t0 = time.perf_counter()
            new[g.name] = _collide_stream(own[g.name], rho_g, u_g, qs)
            sync_device(dev)
            times[g.name] += (time.perf_counter() - t0) * g.slowdown
        return new, times

    one_joint_step(own0)                             # warm
    cur = own0
    comm_per_step = 4 * d ** 3 * 4 / 6e9             # rho + 3 momentum
    step_times = {g.name: [] for g in ex.groups}
    for _ in range(n_steps):
        cur, times = one_joint_step(cur)
        for k, v in times.items():
            step_times[k].append(v)
    # min-per-step x n_steps: robust to host timing jitter
    busy = {k: min(v) * n_steps for k, v in step_times.items()}
    hybrid_time = (max(min(v) for v in step_times.values())
                   + comm_per_step) * n_steps
    value = torch.cat([cur[g.name].to(dest) for g in ex.groups])
    sync_device(dest)
    # single-device alone: all 19 planes on that device (min-of-3 after
    # a warm-up pass, same robustness as the hybrid measurement)
    single = {}
    qs_all = tuple(range(19))
    for g in ex.groups:
        dev = devs[g.name]
        full = value.to(dev)
        best = None
        for it in range(4):
            t0 = time.perf_counter()
            rho_p, mom_p = _partial_moments(full, qs_all)
            u = mom_p / torch.clamp_min(rho_p, 1e-9)[None]
            _collide_stream(full, rho_p, u, qs_all)
            sync_device(dev)
            dt = time.perf_counter() - t0
            if it and (best is None or dt < best):
                best = dt
        single[g.name] = best * g.slowdown * n_steps
    return untraced_output(ex, "LBM", hybrid_time, single, busy, value,
                           units)
