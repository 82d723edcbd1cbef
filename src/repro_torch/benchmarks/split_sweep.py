"""§5.4.3 reproduction: work-split threshold sweep for Conv.

    PYTHONPATH=src python -m repro_torch.benchmarks.split_sweep

Each swept split is *forced* (``plan_override``, stealing disabled so
the split is honored) and executed through the chunked executor, so the
table reports measured makespan next to the model's prediction — the
paper's "adjust it experimentally" loop, with the model's optimum
validated against reality.  Runs the simulated pair on the first GPU
(``force_simulated``) and raises without one; ``run(device="cpu")``
simulates it on the CPU.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import work_sharing
from repro_torch.core.hybrid_executor import HybridExecutor
from repro_torch.workloads import conv


def run(ratio: float = 3.9, size: int = 256, ksize: int = 9,
        n_points: int = 9, device=None):
    ex = HybridExecutor(simulated_ratio=ratio, device=device,
                        force_simulated=True)
    conv.run_hybrid(ex, size=size, ksize=ksize)      # calibrate + warm
    thr = ex.tracker.throughputs([g.name for g in ex.groups])
    total_units = size
    best_meas = best_model = None
    print("split_sweep/host_share,measured_us,model_us")
    for share in np.linspace(0.0, 0.5, n_points):
        k_host = int(total_units * share)
        units = [total_units - k_host, k_host]
        gt = [u / t for u, t in zip(units, thr)]
        model = max(gt)
        out = conv.run_hybrid_with_split(ex, units, size=size, ksize=ksize)
        meas = out.result.hybrid_time
        if best_meas is None or meas < best_meas[1]:
            best_meas = (share, meas)
        if best_model is None or model < best_model[1]:
            best_model = (share, model)
        print(f"split_sweep/{share:.2f},{meas * 1e6:.0f},"
              f"model={model * 1e6:.0f}us")
    analytic = work_sharing.paper_split(1.0, ratio)
    print(f"split_sweep/best,{best_meas[1] * 1e6:.0f},"
          f"measured_best_share={best_meas[0]:.2f}|"
          f"model_best_share={best_model[0]:.2f}|"
          f"paper_rule={analytic:.2f}")


if __name__ == "__main__":
    run()
