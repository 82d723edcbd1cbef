"""Trainer: the paper's hybrid orchestration applied to LM training.

Per global step of ``accum_units`` micro-batches:
  1. plan work shares across device groups proportional to EWMA
     throughput (paper §5.4.3 generalized);
  2. each group computes gradients over its micro-batch share
     (work sharing; a straggler automatically gets fewer units after
     re-planning — straggler mitigation);
  3. gradients are averaged and one optimizer update applied;
  4. host tasks (async checkpoint) overlap device compute (task
     parallelism, Fig 2(b));
  5. failures kill a group -> elastic re-plan; revives re-join.

Work units are micro-batches, so shapes stay uniform.  Step 2 runs
through the ``AsyncChunkExecutor`` at micro-batch granularity: a group
that finishes its share steals micro-batches from the straggler's tail
*within* the step, and the re-plan across steps only has to track slow
drift, not transient hiccups.

As in the reference, the executor always runs in virtual-clock mode:
the gradients of every group flow into one optimizer update, so every
group's micro-batches are computed on the parameters' device (the accel
group's: the GPU on the real pair) one after another, and
``time_model`` (or the measured chunk time times the group's slowdown)
sets the clock.  The parameters are f32 (the reference's storage; the
model casts them at use); the gradients of the chunks are summed in
unit order, the reference's order, into one running sum.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.core import work_sharing
from repro_torch.core.async_executor import AsyncChunkExecutor, primary_device
from repro_torch.core.calibration import ThroughputTracker
from repro_torch.core.hybrid_executor import DeviceGroup, detect_platform
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import (DataConfig, TokenStream,
                                       global_batch_indices)
from repro_torch.ft.failure import FailureInjector
from repro_torch.kernels.common import sync_device
from repro_torch.models import model_zoo
from repro_torch.optim.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.train_step import to_batch, value_and_grad


@dataclass
class TrainerConfig:
    accum_units: int = 4             # micro-batches per global step
    steps: int = 20
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    replan_every: int = 1
    log_every: int = 1
    simulated_ratio: float = 4.0     # heterogeneity when simulating groups
    # Deterministic timing model (group_name, units) -> seconds.  When
    # set, it replaces wall-clock measurement — used to simulate
    # heterogeneity/stragglers reproducibly on a single-device host.
    time_model: Optional[Callable[[str, int], float]] = None
    chunk_units: int = 1             # micro-batches per stealable chunk
    steal: bool = True               # intra-step work stealing


@dataclass
class StepRecord:
    step: int
    loss: float
    units: List[int]                 # planned units per group
    group_times: List[float]         # per-group busy time
    hybrid_time: float               # overlapped makespan, not sum
    idle_fracs: List[float]
    replanned: bool
    steals: int = 0                  # chunks rebalanced mid-step
    executed_units: List[int] = field(default_factory=list)
    grad_norm: float = float("nan")  # before clipping
    wall_s: float = 0.0              # the step's wall time, synchronised


class _InOrderSum:
    """The chunks' gradient trees summed in unit order, as the reference
    sums ``trace.outputs``, while they arrive in the virtual clock's
    order: a chunk that arrives ahead of its turn waits, every other is
    added into the running sum (in place) at once."""

    def __init__(self):
        self.total = None
        self._next = 0
        self._waiting: Dict[int, tuple] = {}

    def add(self, start: int, k: int, grads) -> None:
        self._waiting[start] = (k, grads)
        while self._next in self._waiting:
            k, g = self._waiting.pop(self._next)
            if self.total is None:
                self.total = g
            else:
                for a, x in zip(leaves(self.total), leaves(g)):
                    a.add_(x)
            self._next += k

    def result(self, n_units: int):
        if self._waiting or self._next != n_units:
            raise RuntimeError(f"gradient sum: {self._next} of {n_units} "
                               f"units summed, chunks at "
                               f"{sorted(self._waiting)} left over")
        return self.total


class Trainer:
    """``groups=None`` builds the GPU + CPU pair (``detect_platform``),
    which raises without a GPU unless ``device="cpu"`` asks for the
    simulated pair on the CPU."""

    def __init__(self, cfg: ArchConfig, opt_cfg: OptConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 groups: Optional[List[DeviceGroup]] = None,
                 injector: Optional[FailureInjector] = None,
                 device=None):
        self.cfg, self.opt_cfg, self.data_cfg, self.tcfg = (
            cfg, opt_cfg, data_cfg, tcfg)
        if groups is None:
            groups, _ = detect_platform(tcfg.simulated_ratio, device)
        self.groups = groups
        # the parameters' device: the accel group's
        self.device = primary_device(groups[0])
        self.tracker = ThroughputTracker([g.name for g in groups])
        self.injector = injector or FailureInjector()
        self.stream = TokenStream(data_cfg)
        self.ckpt = (Checkpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.history: List[StepRecord] = []
        self._chunk_exec = AsyncChunkExecutor(
            self.groups, steal=tcfg.steal, time_model=tcfg.time_model)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params = model_zoo.init(self.cfg, seed, device=self.device,
                                dtype=torch.float32)
        opt = init_opt_state(self.opt_cfg, params)
        return {"params": params, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def maybe_restore(self, state):
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state, 0
        state, step = self.ckpt.restore(state)
        return state, int(step) + 1

    # ------------------------------------------------------------------
    def _grad(self, params, index: int):
        batch = to_batch(self.stream.batch(index), self.device)
        loss, _, grads = value_and_grad(params, batch, self.cfg)
        return loss, grads

    def _group_grads(self, params, indices) -> tuple:
        """Run one group's micro-batches; returns (grads_sum, loss_sum).
        The losses are read after the last micro-batch is dispatched, so
        the host queues the next micro-batch while the device runs one."""
        grads = None
        losses = []
        for i in indices:
            loss, g = self._grad(params, i)
            losses.append(loss)
            if grads is None:
                grads = g
            else:
                for a, x in zip(leaves(grads), leaves(g)):
                    a.add_(x)
            del g
        loss_sum = 0.0
        for loss in losses:
            loss_sum += float(loss)
        sync_device(self.device)
        return grads, loss_sum

    def run(self, state=None, start_step: int = 0,
            warmup: bool = True) -> Dict:
        """Steps ``start_step`` .. ``tcfg.steps - 1``.  ``warmup=False``
        skips the untimed warm-up micro-batch: for a run that continues
        in this process, its grad path already warm."""
        tcfg = self.tcfg
        if state is None:
            state = self.init_state()
            state, start_step = self.maybe_restore(state)
        params, opt = state["params"], state["opt"]
        names = [g.name for g in self.groups]
        if warmup:
            # warm up the grad path so first-use costs never poison the
            # throughput calibration (paper §4.5 measures steady state)
            self._grad(params, 1 << 30)
            sync_device(self.device)
        units = work_sharing.integer_shares(
            tcfg.accum_units, self.tracker.throughputs(names))
        self.tracker.mark_planned()

        for step in range(start_step, tcfg.steps):
            rec = self._step(step, params, opt, units, names)
            units = rec.units
            self.history.append(rec)
            if step % tcfg.log_every == 0:
                print(f"[train] step={step} loss={rec.loss:.4f} "
                      f"units={rec.units} idle="
                      f"{['%.0f%%' % (100 * i) for i in rec.idle_fracs]}"
                      + (f" steals={rec.steals}" if rec.steals else "")
                      + (" REPLANNED" if rec.replanned else ""), flush=True)

            if self.ckpt and (step + 1) % tcfg.ckpt_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt,
                                      "step": torch.tensor(
                                          step, dtype=torch.int32)})
        if self.ckpt:
            self.ckpt.wait()
        return {"params": params, "opt": opt, "history": self.history}

    def _step(self, step: int, params, opt, units: List[int],
              names: List[str]) -> StepRecord:
        """One global step: re-plan, the work-shared gradients, one
        update (written into ``params`` and ``opt``)."""
        tcfg = self.tcfg
        t_start = time.perf_counter()
        kill, revive = self.injector.at_step(step)
        replanned = False
        if kill:
            self.tracker.mark_dead(kill)
        if revive:
            self.tracker.mark_alive(revive)
        if (kill or revive or
                (step % tcfg.replan_every == 0
                 and self.tracker.should_replan())):
            units = work_sharing.integer_shares(
                tcfg.accum_units, self.tracker.throughputs(names))
            self.tracker.mark_planned()
            replanned = True

        # ---- work-shared gradient computation (chunk-pipelined,
        # work-stealing: see core.async_executor) ----
        summed = _InOrderSum()

        def run_chunk(group_name, start, k):
            idx = global_batch_indices(step, tcfg.accum_units, start, k)
            grads, loss_sum = self._group_grads(params, idx)
            summed.add(start, k, grads)
            return loss_sum

        thr = self.tracker.throughputs(names)
        priors = {g.name: (1.0 / t if t > 0 else 1.0)
                  for g, t in zip(self.groups, thr)}
        trace = self._chunk_exec.run(units, run_chunk,
                                     tcfg.chunk_units, "virtual",
                                     unit_time_priors=priors)
        loss_total = 0.0
        for loss_sum in trace.outputs:
            loss_total += loss_sum
        times = [trace.group_busy.get(g.name, 0.0) for g in self.groups]
        executed = [trace.group_units.get(g.name, 0)
                    for g in self.groups]
        for g, k_done, dt in zip(self.groups, executed, times):
            if k_done > 0:
                self.tracker.update(g.name, k_done, dt)
        n_units = sum(units)
        grads_total = summed.result(n_units)
        for x in leaves(grads_total):
            x.div_(n_units)
        params, opt, om = apply_updates(self.opt_cfg, params,
                                        grads_total, opt, step)
        del grads_total, summed

        hybrid_time = trace.makespan
        idle = [(hybrid_time - t) / hybrid_time if hybrid_time else 0.0
                for t in times]
        grad_norm = float(om["grad_norm"])
        sync_device(self.device)
        return StepRecord(step, loss_total / max(n_units, 1), list(units),
                          times, hybrid_time, idle, replanned,
                          steals=trace.steals, executed_units=executed,
                          grad_norm=grad_norm,
                          wall_s=time.perf_counter() - t_start)
