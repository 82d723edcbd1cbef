"""Ray casting workload (paper §4.5): two phases, per-phase work shares.

Phase 1 finds each ray's volume entry point; phase 2 marches the ray
accumulating interpolated intensity.  The paper's hybrid insight: ALL
rays finish phase 1 before ANY starts phase 2, and the two phases get
*different* empirically-tuned work shares — here both come from per-phase
calibration.

Each group runs its rays from its own copy of the volume and the rays
on its own device; each phase's ``combine`` gathers the per-ray results
onto the accel group's device inside the executor's timed merge.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import HybridExecutor, WorkSharedOutput
from repro_torch.core.metrics import HybridResult
from repro_torch.kernels.common import sync_device, to_device

N_MARCH_STEPS = 96


def entry_cost_terms() -> CostTerms:
    """Per-ray prior for phase 1 (slab bbox intersection): ~6 mul/add
    per axis plus the min/max reduction; reads o/d, writes t_entry."""
    return CostTerms(flops=24.0, bytes=28.0)


def march_cost_terms(n_steps: int = N_MARCH_STEPS) -> CostTerms:
    """Per-ray prior for phase 2: per step, 8 trilinear corner samples
    (gather + 3-factor weight products) and the position update —
    ~60 flops and 8 volume reads."""
    return CostTerms(flops=60.0 * n_steps, bytes=4.0 * 9.0 * n_steps)


@functools.lru_cache(maxsize=4)
def make_volume(d: int = 64, seed: int = 0) -> np.ndarray:
    """Deterministic numpy volume (the reference's generator), memoized
    out of timed paths."""
    rng = np.random.default_rng(seed)
    return rng.random((d, d, d)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def make_rays(n: int, seed: int = 1):
    """Deterministic numpy ray origins and unit directions (the
    reference's generator), memoized out of timed paths."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.random(n), rng.random(n), -np.ones(n)], -1)
    d = np.stack([np.zeros(n), np.zeros(n), np.ones(n)], -1)
    d += rng.standard_normal((n, 3)) * 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _placed(n_rays: int, d: int, device: str):
    return to_device((make_volume(d), *make_rays(n_rays)), device)


def entry(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Phase 1: slab bbox intersection -> t_entry per ray."""
    inv = 1.0 / torch.where(rays_d.abs() < 1e-9, 1e-9, rays_d)
    t0 = (0.0 - rays_o) * inv
    t1 = (1.0 - rays_o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    return torch.clamp_min(tmin, 0.0)


def _sample(vol: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``vol`` at the points ``p`` (..., 3):
    the 8 corners gathered at once from the flat volume."""
    D = vol.shape[0]
    g = p.clamp(0.0, 1.0) * (D - 1)
    i0 = torch.floor(g).long()
    i1 = torch.clamp_max(i0 + 1, D - 1)
    f = g - i0
    idx = torch.stack([i0, i1], -1)                  # (..., 3, 2)
    w = torch.stack([1 - f, f], -1)                  # (..., 3, 2)
    flat = ((idx[..., 0, :, None, None] * D + idx[..., 1, None, :, None])
            * D + idx[..., 2, None, None, :])        # (..., 2, 2, 2)
    wt = (w[..., 0, :, None, None] * w[..., 1, None, :, None]
          * w[..., 2, None, None, :])
    return (wt * vol.reshape(-1)[flat]).sum((-3, -2, -1))


def march(vol: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
          t_in: torch.Tensor, n_steps: int = N_MARCH_STEPS) -> torch.Tensor:
    """Phase 2: fixed-step trilinear sampling accumulation (the
    reference's ``fori_loop``, one step of torch ops at a time)."""
    dt = np.float32(1.7 / n_steps)
    acc = torch.zeros(rays_o.shape[:-1], dtype=torch.float32,
                      device=rays_o.device)
    for k in range(n_steps):
        # the step offset in f32, as the reference's traced k * dt
        p = rays_o + rays_d * (t_in + float(np.float32(k) * dt))[..., None]
        inside = ((p >= 0) & (p <= 1)).all(-1)
        acc = acc + torch.where(inside, _sample(vol, p), 0.0) * float(dt)
    return acc


def run_hybrid(ex: HybridExecutor, n_rays: int = 1 << 16, d: int = 64
               ) -> WorkSharedOutput:
    placed = {g.name: _placed(n_rays, d, str(primary_device(g)))
              for g in ex.groups}
    dest = primary_device(ex.groups[0])

    def combine(outs):
        value = torch.cat([o.to(dest) for o in outs])
        sync_device(dest)
        return value

    # ---- phase 1 (entry) ----
    def p1(group, start, k):
        _, ro, rd = placed[group]
        t = entry(ro[start:start + k], rd[start:start + k])
        sync_device(ro.device)
        return t

    ex.calibrate(lambda g, k: p1(g, 0, k), probe_units=n_rays // 8,
                 workload=f"RC/entry/{n_rays}x{d}",
                 unit_cost=entry_cost_terms())
    o1 = ex.run_work_shared("RC/entry", n_rays, p1, combine)
    # every group's copy of the entry points, between the phases
    t_in = {g.name: o1.value.to(primary_device(g)) for g in ex.groups}
    for g in ex.groups:
        sync_device(primary_device(g))

    # ---- phase 2 (march) — fresh calibration: different cost profile ----
    def p2(group, start, k):
        vol, ro, rd = placed[group]
        c = march(vol, ro[start:start + k], rd[start:start + k],
                  t_in[group][start:start + k])
        sync_device(vol.device)
        return c

    ex.calibrate(lambda g, k: p2(g, 0, k), probe_units=n_rays // 16,
                 workload=f"RC/march/{n_rays}x{d}",
                 unit_cost=march_cost_terms())
    o2 = ex.run_work_shared("RC", n_rays, p2, combine)
    # combined metrics over both phases; the trace is the march's
    r1, r2 = o1.result, o2.result
    res = HybridResult(
        "RC", r1.hybrid_time + r2.hybrid_time,
        {g: r1.single_times[g] + r2.single_times[g]
         for g in r1.single_times},
        {g: r1.busy_times[g] + r2.busy_times[g] for g in r1.busy_times})
    return WorkSharedOutput(o2.value, res, o2.plan, o2.simulated, o2.trace)
