"""Table 2 reproduction: gain% + idle% for the 13 workloads on two
simulated platforms (Hybrid-High ~ 10x accel:host throughput ratio,
Hybrid-Low ~ 3.9x — the paper's i7-980X+TeslaT10 and E7400+GT520).

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_hybrid

Runs both simulated pairs on the first GPU (``force_simulated``) and
raises without one; ``run(device="cpu")`` simulates them on the CPU.
Prints one CSV row per (workload, platform): name,us_per_call,derived.
"""
from __future__ import annotations

import importlib
import time

from repro_torch.core.hybrid_executor import HybridExecutor
from repro_torch.workloads import ALL_WORKLOADS

# benchmark-scale inputs (the reference's; the paper uses the largest
# inputs that fit GPU memory)
SIZES = dict(
    sort=dict(n=1 << 18), hist=dict(n=1 << 21), spmv=dict(n=4096),
    spgemm=dict(n=768), raycast=dict(n_rays=1 << 16, d=48),
    bilateral=dict(size=256), conv=dict(size=768, ksize=15),
    montecarlo=dict(n_photons=1 << 17, unit=1 << 12),
    listrank=dict(n=1 << 18), concomp=dict(n=1 << 15),
    lbm=dict(d=40, n_steps=3), dither=dict(h=128, w=128),
    bundle=dict(n_cams=4, n_pts=256),
)

PLATFORMS = {"Hybrid-High": 10.0, "Hybrid-Low": 3.9}

# Paper Table 2 reference gains (%) for comparison columns
PAPER_GAIN = {
    "sort": (18.6, 28.9), "hist": (32.3, 21.8), "spmv": (15.1, 48.4),
    "spgemm": (38.9, 41.87), "RC": (23.8, 39.7), "LBM": (15.0, 11.6),
    "Bilat": (12.9, 7.22), "Conv": (23.5, 41.0), "MC": (15.7, 16.8),
    "LR": (57.7, 33.9), "CC": (45.16, 56.4), "Dither": (25.5, 10.5),
    "Bundle": (88.4, 78.8),
}


def run(csv: bool = True, device=None):
    rows = []
    results = {}
    for pi, (pname, ratio) in enumerate(PLATFORMS.items()):
        for name in ALL_WORKLOADS:
            mod = importlib.import_module(f"repro_torch.workloads.{name}")
            # force the simulated pair: the whole point of this table is
            # the throughput *ratio*, which the real GPU+CPU pair would
            # otherwise replace with its own
            ex = HybridExecutor(simulated_ratio=ratio, device=device,
                                force_simulated=True)
            t0 = time.perf_counter()
            out = mod.run_hybrid(ex, **SIZES.get(name, {}))
            wall = (time.perf_counter() - t0) * 1e6
            r = out.result
            paper = PAPER_GAIN.get(r.workload, (0, 0))[pi]
            idle = max(r.idle_fracs.values()) if r.idle_fracs else 0.0
            model = (f"|measured={r.hybrid_time * 1e6:.0f}us"
                     f"|model={r.analytic_time * 1e6:.0f}us"
                     if r.analytic_time > 0 else "")
            rows.append(
                f"table2/{pname}/{r.workload},{wall:.0f},"
                f"gain={100 * r.gain:.1f}%|paper={paper}%|"
                f"idle={100 * idle:.1f}%|eff={100 * r.resource_efficiency:.1f}%"
                + model)
            results.setdefault(pname, []).append(r)
    if csv:
        for row in rows:
            print(row)
    for pname, rs in results.items():
        mean_gain = sum(r.gain for r in rs) / len(rs)
        mean_eff = sum(r.resource_efficiency for r in rs) / len(rs)
        print(f"table2/{pname}/MEAN,0,gain={100 * mean_gain:.1f}%|"
              f"eff={100 * mean_eff:.1f}%")
    return results


if __name__ == "__main__":
    run()
