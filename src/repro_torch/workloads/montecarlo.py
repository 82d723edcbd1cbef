"""Monte Carlo workload (paper §4.7): photon-migration-style estimator.

Task parallelism exactly as the paper: the host generates the
pseudorandom stream (core.host_offload.host_prng_stream) on a host task
pool while the accelerator consumes it in the simulation; photon counts
are the work-share unit.  Each group simulates its photons from its own
copy of the stream on its own device (placed once, outside the timed
path); ``combine`` sums the groups' absorbed weights on the accel
group's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.host_offload import HostTaskPool, host_prng_stream
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.kernels.common import sync_device, to_device

N_STEPS = 32
MU_A, MU_S = 0.1, 0.9                 # absorption / scattering
SEED = 42


def unit_cost_terms(unit: int) -> CostTerms:
    """Prior for ONE work unit of ``unit`` photons: per interaction
    step each photon pays ~6 elementwise ops (weight decay, roulette,
    select) and reads its 4-byte uniform."""
    return CostTerms(flops=6.0 * unit * N_STEPS,
                     bytes=4.0 * unit * N_STEPS)


@functools.lru_cache(maxsize=2)
def make_stream(n_photons: int, seed: int = SEED) -> np.ndarray:
    """The (n_photons, N_STEPS) uniforms, generated by a host task (the
    reference's stream: the same seed gives bit-identical values),
    memoized out of timed paths."""
    pool = HostTaskPool()
    try:
        fut = pool.submit("prng", host_prng_stream, seed,
                          n_photons * N_STEPS)
        return fut.result().reshape(n_photons, N_STEPS)
    finally:
        pool.shutdown()


@functools.lru_cache(maxsize=2)
def _placed(n_photons: int, device: str) -> torch.Tensor:
    return to_device(make_stream(n_photons), device)


def simulate_photons(u: torch.Tensor) -> torch.Tensor:
    """u: (N, N_STEPS) uniform randoms -> mean absorbed weight.

    Each photon loses MU_A/(MU_A+MU_S) of its weight per interaction and
    terminates below a threshold (Russian roulette with supplied u)."""
    w = torch.ones(u.shape[0], dtype=torch.float32, device=u.device)
    absorbed = torch.zeros_like(w)
    for k in range(N_STEPS):
        dw = w * (MU_A / (MU_A + MU_S))
        absorbed = absorbed + dw
        w = w - dw
        survive = u[:, k] < 0.9
        w = torch.where(survive | (w > 1e-4), w, 0.0)
    return absorbed.mean()


def run_hybrid(ex: HybridExecutor, n_photons: int = 1 << 18,
               unit: int = 1 << 12, plan_override=None) -> WorkSharedOutput:
    units = n_photons // unit
    placed = {g.name: _placed(n_photons, str(primary_device(g)))
              for g in ex.groups}
    dest = primary_device(ex.groups[0])

    def run_share(group, start, k):
        u = placed[group]
        out = simulate_photons(u[start * unit:(start + k) * unit]) * (k * unit)
        sync_device(u.device)
        return out

    def combine(outs):
        return float(torch.stack([o.to(dest) for o in outs]).sum()
                     ) / n_photons

    ex.calibrate(lambda g, k: run_share(g, 0, k), probe_units=units // 8,
                 workload=f"MC/{n_photons}x{unit}",
                 unit_cost=unit_cost_terms(unit))
    return ex.run_work_shared("MC", units, run_share, combine,
                              comm_cost=n_photons * N_STEPS * 4 / 6e9,
                              plan_override=plan_override)
