"""Bundle adjustment workload (paper §4.10, [15]): LM task pipeline.

Levenberg-Marquardt over synthetic cameras+points: the step decomposes
into tasks — residuals & Jacobian blocks (accelerator), normal-equation
assembly (accelerator), damped solve (host: small dense system, exactly
the kind of task the paper leaves on the CPU), update & re-evaluate.
Scheduled with the task scheduler; the paper notes some tasks cannot be
subdivided, which is why Bundle shows the highest idle time in Table 2 —
the same effect reproduces here.  The device tasks are timed on the
accel group's device and the host solve with numpy; the other device
class is priced as that time x its ``slowdown``: the reference's model.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.calibration import measure
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.hybrid_executor import (
    HybridExecutor, WorkSharedOutput, scheduled_output)
from repro_torch.core.task_graph import TaskGraph
from repro_torch.kernels.common import to_device


def unit_cost_terms(n_cams: int, n_pts: int, n_iters: int = 3
                    ) -> CostTerms:
    """Prior for one FULL LM request: per iteration the forward-mode
    Jacobian (~P residual passes), the J^T J normal equations
    (2*N*P^2) and the damped solve (P^3/3) dominate — all contraction
    work, so it rates at the matmul peak.  Iterations are sequential:
    one indivisible unit for serving placement (the paper's point —
    the solve tasks are host-only, the request has no data split)."""
    n_res = 2.0 * n_cams * n_pts
    p = 6.0 * n_cams
    per_iter = 2.0 * n_res * p * (p + 1.0) + p ** 3 / 3.0
    return CostTerms(flops=per_iter * n_iters,
                     bytes=4.0 * (n_res * p + p * p) * n_iters,
                     steps=n_iters, compute="matmul")


@functools.lru_cache(maxsize=4)
def make_problem(n_cams: int = 4, n_pts: int = 256, seed: int = 0):
    """Deterministic numpy cameras, points and noisy observations (the
    reference's generator; the clean observations are the projection,
    computed on the CPU), memoized out of timed paths."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n_pts, 3)).astype(np.float32)
    cams = (rng.standard_normal((n_cams, 6)) * 0.1).astype(np.float32)
    cams[:, 5] += 4.0                        # push cameras back in z
    obs = _project(torch.from_numpy(cams), torch.from_numpy(pts)).numpy()
    obs = obs + 0.01 * rng.standard_normal(obs.shape).astype(np.float32)
    return cams, pts, obs


def _rot(w: torch.Tensor) -> torch.Tensor:
    """Small-angle rotation (I + [w]x)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    K = torch.stack([torch.stack([z, -wz, wy], -1),
                     torch.stack([wz, z, -wx], -1),
                     torch.stack([-wy, wx, z], -1)], -2)
    return torch.eye(3, dtype=w.dtype, device=w.device) + K


def _project(cams: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """cams: (C, 6) [rotvec, t]; pts: (P, 3) -> (C, P, 2)."""
    R = _rot(cams[:, :3])                    # (C, 3, 3)
    X = torch.einsum("cij,pj->cpi", R, pts) + cams[:, None, 3:]
    return X[..., :2] / torch.clamp_min(X[..., 2:3], 1e-3)


def residuals(cams, pts, obs):
    return (_project(cams, pts) - obs).reshape(-1)


def lm_step(cams, pts, obs, lam: float):
    """One damped LM step over camera parameters; returns the new
    cameras and the squared residual before the step."""
    def r_of(c_flat):
        return residuals(c_flat.reshape(cams.shape), pts, obs)

    c_flat = cams.reshape(-1)
    r = r_of(c_flat)
    J = torch.func.jacfwd(r_of)(c_flat)      # (N_res, 6C) device task
    JtJ = J.T @ J
    Jtr = J.T @ r
    A = JtJ + lam * torch.diag(torch.diag(JtJ))
    # damped solve -> host task in the schedule (small dense system)
    delta = torch.linalg.solve(A, Jtr)
    new = (c_flat - delta).reshape(cams.shape)
    return new, float(torch.sum(r ** 2))


def run_hybrid(ex: HybridExecutor, n_cams: int = 4, n_pts: int = 256,
               n_iters: int = 3) -> WorkSharedOutput:
    dev = primary_device(ex.groups[0])
    cams, pts, obs = to_device(make_problem(n_cams, n_pts), dev)
    slow = {g.name: g.slowdown for g in ex.groups}

    # ---- measured task costs, on the accel group's device ----
    t_res = measure(lambda: residuals(cams, pts, obs))
    t_step = measure(lambda: lm_step(cams, pts, obs, 1e-3)[0])
    t_jac = max(t_step - t_res, t_res)       # jac + normal eqs dominate
    # the damped solve is a tiny dense system: measure the HOST solver
    # for real (numpy); the accelerator pays a launch-latency floor —
    # exactly the "right task on the right processor" asymmetry (§5.4.4)
    A = np.eye(6 * n_cams, dtype=np.float32) * 2.0
    b = np.ones(6 * n_cams, np.float32)
    t_solve_host = measure(lambda: np.linalg.solve(A, b))

    # The paper: "there is no equivalent Pure-GPU code — the hybrid code
    # is a direct extension of the available CPU code."  The damping /
    # solve / control tasks are HOST-ONLY; the accelerator takes the
    # Jacobian & residual kernels.  That asymmetry is why Bundle shows
    # the paper's highest idle time (77%) — reproduced here.
    g = TaskGraph()
    for i in range(n_iters):
        deps = [f"upd{i-1}"] if i else []
        g.add(f"jac{i}", {"accel": t_jac * slow["accel"],
                          "host": t_jac * slow["host"] * 2.5}, deps=deps,
              output_bytes=(6 * n_cams) ** 2 * 4)
        g.add(f"solve{i}", {"host": t_solve_host * slow["host"]},
              deps=[f"jac{i}"], output_bytes=6 * n_cams * 4)
        g.add(f"upd{i}", {"host": t_res * slow["host"]},
              deps=[f"solve{i}"])
    sched = g.schedule({"accel": "accel", "host": "host"}, link_bw=6e9)

    # run the actual optimization for the value
    err = float("inf")
    cur = cams
    for i in range(n_iters):
        cur, err = lm_step(cur, pts, obs, 1e-3)

    # host-alone exists (the original CPU code); accel-alone does not
    # (host-only tasks) -> only the host single time is finite
    single = {"host": sum(t.costs["host"] for t in g.tasks.values())}
    return scheduled_output(ex, "Bundle", sched, single, float(err),
                            [n_iters, n_iters])
