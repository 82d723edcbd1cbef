"""Fig. 5 reproduction: the LR hybrid task assignment timeline.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_tasks

Runs listrank on the simulated pair at the paper's Hybrid-High ratio
(10) on the first GPU (``force_simulated``) and raises without one;
``run(device="cpu")`` simulates it on the CPU.  Prints one CSV row
(name,us_per_call,derived) and each group's busy time and idle share.
"""
from __future__ import annotations

from repro_torch.core.hybrid_executor import HybridExecutor
from repro_torch.workloads import listrank


def run(n: int = 1 << 18, ratio: float = 10.0, device=None):
    ex = HybridExecutor(simulated_ratio=ratio, device=device,
                        force_simulated=True)
    out = listrank.run_hybrid(ex, n=n)
    r = out.result
    print(f"fig5/LR,{r.hybrid_time * 1e6:.0f},gain={100 * r.gain:.1f}%|"
          f"paper=57.7%@HybridHigh")
    for g, busy in r.busy_times.items():
        print(f"  {g:6s} busy {busy * 1e3:8.3f}ms "
              f"idle {100 * r.idle_fracs[g]:5.1f}%")
    return out


if __name__ == "__main__":
    run()
