"""Quickstart: the hybrid engine + a tiny LM, on the GPU and the CPU.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Runs on the first GPU (the hybrid pair is the GPU and the CPU, the LM
on the GPU) and raises without one; ``main(device="cpu")`` simulates
the pair on the CPU and runs the LM there.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import HybridExecutor, plan_work
from repro_torch.core.task_graph import TaskGraph
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model_zoo
from repro_torch.workloads import conv


def main(device=None, size: int = 256, ksize: int = 9,
         seq: int = 64) -> dict:
    dev = resolve_device(device)
    out = {}

    # --- 1. the paper's work-sharing rule ---------------------------------
    plan = plan_work(total_units=100, throughputs=[4.0, 1.0])
    print("work plan:", plan.summary())
    out["plan"] = plan

    # --- 2. a task graph, HEFT-scheduled (paper Fig. 5 style) -------------
    g = (TaskGraph()
         .add("prng", {"cpu": 0.5, "gpu": 2.0}, output_bytes=512e6)
         .add("fis", {"gpu": 0.6}, deps=["prng"])
         .add("rank", {"gpu": 1.0, "cpu": 8.0}, deps=["fis"]))
    sched = g.schedule({"cpu0": "cpu", "gpu0": "gpu"})
    print("schedule makespan:", round(sched.makespan, 3),
          "critical path:", sched.critical_path)
    out["schedule"] = sched

    # --- 3. a hybrid workload end-to-end ----------------------------------
    ex = HybridExecutor(simulated_ratio=4.0, device=dev)
    hybrid = conv.run_hybrid(ex, size=size, ksize=ksize)
    print("hybrid conv:", hybrid.result.row())
    out["hybrid"] = hybrid

    # --- 4. a tiny LM forward ---------------------------------------------
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                     n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
                     head_dim=32)
    params = model_zoo.init(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, 512, (2, seq), generator=gen, device=dev)
    with torch.inference_mode():
        logits, _ = model_zoo.forward(cfg, params, {"tokens": tokens})
    print("tiny LM logits:", tuple(logits.shape), "finite:",
          bool(torch.isfinite(logits.float()).all()))
    out["logits"] = logits
    return out


if __name__ == "__main__":
    main()
