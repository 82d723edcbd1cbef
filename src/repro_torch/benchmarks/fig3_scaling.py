"""Fig. 3 reproduction: hybrid gain over increasing input sizes for a
representative subset of workloads (one per solution methodology).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_scaling

Runs the simulated pair on the first GPU (``force_simulated``) and
raises without one; ``run(device="cpu")`` simulates it on the CPU.
"""
from __future__ import annotations

import importlib

from repro_torch.core.hybrid_executor import HybridExecutor

SWEEPS = {
    "conv": [dict(size=s, ksize=9) for s in (128, 256, 512, 768)],
    "hist": [dict(n=1 << p) for p in (18, 19, 20, 21)],
    "spmv": [dict(n=s) for s in (1024, 2048, 4096)],
    "montecarlo": [dict(n_photons=1 << p, unit=1 << 12)
                   for p in (14, 15, 16, 17)],
}


def run(ratio: float = 3.9, device=None):
    for name, sweep in SWEEPS.items():
        mod = importlib.import_module(f"repro_torch.workloads.{name}")
        for kw in sweep:
            ex = HybridExecutor(simulated_ratio=ratio, device=device,
                                force_simulated=True)
            out = mod.run_hybrid(ex, **kw)
            r = out.result
            size = list(kw.values())[0]
            print(f"fig3/{r.workload}/{size},"
                  f"{r.hybrid_time * 1e6:.0f},gain={100 * r.gain:.1f}%")


if __name__ == "__main__":
    run()
