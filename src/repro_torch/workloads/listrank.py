"""List ranking workload (paper §4.8, Fig. 5): task parallelism.

Helman-JaJa-style ranking needs a fresh pseudorandom stream every
fractional-independent-set round.  The paper's hybrid: the CPU generates
the stream for round r+1 *while* the GPU executes round r (Fig. 5), and
PRNG is intrinsically cheaper on the CPU.  Here:

  * accel round cost  = measured pointer-jump round (irregular gathers);
  * host PRNG cost    = measured numpy stream generation;
  * accel PRNG cost   = measured ``torch.rand`` stream on the accel
    group's device (the device-side alternative a GPU-alone solution
    must pay);

and the per-round pipeline is HEFT-scheduled.  Every task is timed
once, on the accel group's device (or the host, for the numpy stream),
and the other device class is priced as that time x its ``slowdown``:
the reference's model, which on the real pair (slowdowns 1) says
nothing of the CPU.  The computed ranks come from the real
pointer-jumping implementation below.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.async_executor import primary_device
from repro_torch.core.calibration import measure
from repro_torch.core.cost_model import CostTerms
from repro_torch.core.host_offload import host_prng_stream
from repro_torch.core.hybrid_executor import (
    HybridExecutor, WorkSharedOutput, scheduled_output)
from repro_torch.core.task_graph import TaskGraph
from repro_torch.kernels.common import sync_device, to_device


def unit_cost_terms(n: int) -> CostTerms:
    """Prior for one FULL ranking request over ``n`` nodes: Wyllie
    pointer jumping runs ~log2(n) rounds, each two irregular gathers
    (succ[succ], rank[succ]) and an add over every node.  The rounds
    are sequential — the request is one indivisible unit for serving
    placement (the hybrid win inside it is the Fig. 5 PRNG pipeline,
    not a work split)."""
    rounds = max(float(np.ceil(np.log2(max(n, 2)))), 1.0)
    return CostTerms(flops=2.0 * n * rounds,
                     bytes=8.0 * 4.0 * n * rounds,
                     steps=int(rounds))


@functools.lru_cache(maxsize=4)
def make_list(n: int, seed: int = 0):
    """Random linked list as a numpy successor array (the reference's
    generator); the tail points to itself.  Returns (succ, head)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    succ = np.empty(n, np.int64)
    succ[perm[:-1]] = perm[1:]
    succ[perm[-1]] = perm[-1]
    return succ, int(perm[0])


def pointer_jump_rank(succ: torch.Tensor) -> torch.Tensor:
    """Wyllie pointer jumping: rank = distance to the tail (int32).
    The reference's ``while_loop``: one round of gathers at a time, one
    host sync a round to test for the fixed point."""
    n = succ.shape[0]
    rank = (succ != torch.arange(n, device=succ.device)).to(torch.int32)
    while True:
        nxt = succ[succ]
        if not bool((succ != nxt).any()):
            return rank
        rank = rank + rank[succ]
        succ = nxt


def _one_round(succ, rank):
    return succ[succ], rank + rank[succ]


def run_hybrid(ex: HybridExecutor, n: int = 1 << 18) -> WorkSharedOutput:
    dev = primary_device(ex.groups[0])
    succ = to_device(make_list(n)[0], dev)
    slow = {g.name: g.slowdown for g in ex.groups}
    rounds = max(int(np.ceil(np.log2(n))), 1)

    # ---- measured task costs ----
    rank0 = (succ != torch.arange(n, device=dev)).to(torch.int32)
    t_round = measure(lambda: _one_round(succ, rank0))
    t_prng_host = measure(lambda: host_prng_stream(7, n))
    gen = torch.Generator(device=dev).manual_seed(0)
    t_prng_accel = measure(lambda: torch.rand(n, generator=gen, device=dev))

    # ---- Fig. 5 pipeline: prng streams are independent tasks, so the
    # host can generate stream r+1 while the accel runs round r ----
    g = TaskGraph()
    for r in range(rounds):
        g.add(f"prng{r}", {"host": t_prng_host * slow["host"],
                           "accel": t_prng_accel * slow["accel"]},
              output_bytes=n * 4)
        g.add(f"fis{r}", {"accel": t_round * slow["accel"],
                          "host": t_round * slow["host"]},
              deps=[f"prng{r}"] + ([f"fis{r-1}"] if r else []))
    g.add("expand", {"accel": t_round * slow["accel"],
                     "host": t_round * slow["host"]},
          deps=[f"fis{rounds-1}"])
    sched = g.schedule({"host": "host", "accel": "accel"}, link_bw=6e9)

    single = {name: sum(t.costs[cls] for t in g.tasks.values()
                        if cls in t.costs)
              for name, cls in (("accel", "accel"), ("host", "host"))}

    rank = pointer_jump_rank(succ)           # the actual answer
    sync_device(dev)
    return scheduled_output(ex, "LR", sched, single, rank, [rounds, rounds])
