"""Fig. 4 reproduction: CPU/GPU overlapped execution timeline for the
Conv hybrid solution.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4_overlap

The timeline is drawn from the actual per-chunk execution records, and
the *measured* makespan is reported side by side with the analytic
overlap-model makespan (max(k_i/thr_i) + comm).  Steady state is what
gets reported — the paper also times steady state ("spmv is used over
multiple iterations"): two warm-up calls converge the calibration-cache
EWMA from the probe's large-block per-unit time to chunk-level per-unit
time, then the median (by makespan) of three timed runs damps
machine-noise outliers.  Runs the simulated pair on the first GPU
(``force_simulated``) and raises without one; ``run(device="cpu")``
simulates it on the CPU.
"""
from __future__ import annotations

from repro_torch.core.hybrid_executor import HybridExecutor
from repro_torch.workloads import conv


def run(size: int = 768, ksize: int = 15, ratio: float = 10.0,
        n_chunks: int = 32, device=None):
    # 32 chunks (vs the default 16) so even the slow group's small
    # share spans several chunks — a sporadic machine-noise spike on a
    # single chunk is slowdown-amplified in virtual mode, and averaging
    # over more chunks keeps it from defining the whole makespan
    def one_run():
        return conv.run_hybrid(
            HybridExecutor(simulated_ratio=ratio, n_chunks=n_chunks,
                           device=device, force_simulated=True),
            size=size, ksize=ksize)
    for _ in range(2):                               # warm cache+kernels
        one_run()
    runs = [one_run() for _ in range(3)]
    out = sorted(runs, key=lambda o: o.result.hybrid_time)[1]
    r = out.result
    done = out.trace.group_units
    frac = done.get("host", 0) / max(sum(done.values()), 1)
    agree = 100 * r.model_agreement
    print(f"fig4/conv_split,{r.hybrid_time * 1e6:.0f},"
          f"host_share={100 * frac:.1f}%|paper=18%@3600x3600")
    print(f"fig4/conv_measured_vs_model,{r.hybrid_time * 1e6:.0f},"
          f"model={r.analytic_observed_time * 1e6:.0f}us|agree_within="
          f"{100 * r.overlap_agreement:.1f}%|"
          f"planned_model={r.analytic_time * 1e6:.0f}us"
          f"(±{agree:.0f}%)|mode={r.mode}|steals={r.steals}")
    width = 60
    t_h = r.hybrid_time
    for g, busy in r.busy_times.items():
        bar = int(width * busy / t_h) if t_h else 0
        print(f"  {g:6s} |{'#' * bar}{'.' * (width - bar)}| "
              f"{busy * 1e3:.2f}ms busy / {t_h * 1e3:.2f}ms span")
    # chunk-level Gantt from the execution trace (time -> columns)
    if out.trace is not None and out.trace.makespan > 0:
        span = out.trace.makespan
        groups = sorted({rec.group for rec in out.trace.records})
        for g in groups:
            row = ["."] * width
            for rec in out.trace.records:
                if rec.group != g:
                    continue
                lo = int(width * rec.t_start / span)
                hi = max(int(width * rec.t_end / span), lo + 1)
                ch = "s" if rec.stolen else "#"
                for i in range(lo, min(hi, width)):
                    row[i] = ch
            print(f"  {g:6s} [{''.join(row)}] chunks (s=stolen)")
    return out


if __name__ == "__main__":
    run()
