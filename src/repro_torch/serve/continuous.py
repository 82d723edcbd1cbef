"""Iteration-level scheduling engine: the decode step is the quantum.

PR-4/5 serve LM requests as monolithic unpreemptible units, so a
64-token decode occupies its lane end-to-end while same-shape arrivals
queue behind it — head-of-line blocking the paper's own lens diagnoses
as using the wrong scheduling granularity.  This engine makes one
*decode step* the scheduling quantum instead:

* live requests' rows live in fixed slots of a pow2-sized state tree,
  and every step is ONE batched call over all S slots
  (``serve_step.make_slot_step``: one ``decode_step`` whose rows sit at
  their own positions), so shapes stay fixed no matter how many rows
  are live — dead slots compute garbage that nothing reads, which is
  what keeps join/evict bit-identical to solo decode (every op of the
  step is row-independent);
* new same-bucket arrivals join the running batch at the next step
  boundary (their prefill runs on a separate lane, see below) instead
  of waiting for the batch to drain;
* finished rows are evicted at the boundary and their outputs demuxed
  exactly per request.

**Prefill/decode disaggregation** (paper §5.4.3 suitability split):
compute-bound prefill runs as a dedicated unit on the projected-fastest
lane while the bandwidth-bound step-loop is co-scheduled on the other
lane — the Scheduler picks both lanes from ``CostTerms`` priors
(``cost_model.lm_prefill_terms``/``lm_decode_terms``) scaled by group
slowdown, so a fresh process places with zero probe runs.

The same mechanism generalizes past LMs: any sequential workload whose
unit of progress is "one iteration over carried state" (listrank
pointer-jump rounds, LBM BGK steps, dither rows) gets iteration-
boundary yield points for free — the step loop releases its lane locks
between steps, so other lane work interleaves and same-shape requests
stack into the slot-batched state (``IterStepper``).

Devices: the engine's two lanes may be two devices (on the GPU + CPU
pair the cost model may put prefill on the card and decode on the
host).  ``insert`` moves a row's state to the slot state's device once,
at join; the slot state lives on the decode lane's device, and a step
or an insert called from a lane on another device raises instead of
copying every step.

Steppers are duck-typed; the engine needs::

    workload      str, registry name this engine serves
    n_slots       int, fixed slot count (pow2 keeps shapes stable)
    prefill_cost  CostTerms for one request's join work
    decode_cost   CostTerms for one batched step
    init_slots()            -> state
    prefill(spec)           -> [(row_state, first_out, n_steps), ...]
    insert(state, slot, row_state) -> state
    step(state)             -> (state, outs)   # outs indexable by slot
    #                                            or None (state carries)
    finish(state, slot, first_out, collected) -> row value
    assemble(row_values)    -> request value (solo-identical order)
"""
from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels.common import current_device, lane_device, sync_device
from repro_torch.obs import get_recorder

_LIVE: "weakref.WeakSet[ContinuousEngine]" = weakref.WeakSet()


def shutdown_all(timeout: float = 10.0) -> None:
    """Stop every live engine (test teardown safety net)."""
    for eng in list(_LIVE):
        eng.shutdown(timeout=timeout)


class _Pending:
    """One submitted request in flight through the engine."""

    __slots__ = ("req", "spec", "t_start", "n_rows", "row_values")

    def __init__(self, req, spec, t_start: float):
        self.req = req
        self.spec = spec
        self.t_start = t_start
        self.n_rows = 0                      # set once prefill ran
        self.row_values: Dict[int, object] = {}


class _Row:
    """One live slot-resident row."""

    __slots__ = ("pending", "row_index", "first_out", "remaining",
                 "collected", "slot")

    def __init__(self, pending: _Pending, row_index: int, first_out,
                 remaining: int):
        self.pending = pending
        self.row_index = row_index
        self.first_out = first_out
        self.remaining = int(remaining)
        self.collected: List[object] = []
        self.slot = -1


class ContinuousEngine:
    """Step-quantum engine for one (stepper, lane-assignment) pair.

    Two threads: ``serve-cb-<wl>-prefill`` turns submissions into slot
    rows on the prefill lane; ``serve-cb-<wl>-step`` runs the batched
    step loop on the decode lane, joining ready rows and evicting
    finished ones at every step boundary.  Lane locks are acquired
    per-phase and *released between steps* — that release IS the
    preemption point: any dedicated/shared work the Scheduler placed on
    the same lane interleaves at iteration boundaries instead of
    waiting for a whole request.

    ``resolve(req, value, t_start)`` is the Scheduler's ``_resolve``
    (keeps the accounting invariant: every submitted request is
    completed/failed exactly once); ``hooks`` may carry ``on_step``,
    ``on_join``, ``on_evict``, ``on_cancel``, ``on_preempt`` counters
    (called outside locks).

    ``should_yield()`` (optional) is polled at every step boundary:
    while it returns True — the Scheduler dispatched latency-class
    deadline work at this engine's lane — the step loop pauses
    (bounded) instead of re-grabbing the lane lock, so the urgent work
    wins the lock handoff.  A batch whose own live rows include a
    latency-class request never yields: pausing it would starve
    exactly the class being prioritized.

    A row whose request future is already resolved — a hedge duplicate
    won the race, or the scheduler rejected it at shutdown — is dropped
    at the next step boundary without finishing: joins skip it, live
    slots free it.  That is the PR-6 preemption point doing cancellation
    duty; at most one extra step is ever spent on a loser.
    """

    def __init__(self, stepper, *,
                 resolve: Callable[[object, object, float], None],
                 reject: Callable[[object, BaseException], None],
                 prefill_locks: Optional[List[threading.Lock]] = None,
                 step_locks: Optional[List[threading.Lock]] = None,
                 prefill_group: str = "", decode_group: str = "",
                 prefill_ctx: Optional[Callable] = None,
                 step_ctx: Optional[Callable] = None,
                 should_yield: Optional[Callable[[], bool]] = None,
                 yield_max_s: float = 0.1,
                 hooks: Optional[Dict[str, Callable]] = None,
                 clock: Optional[Callable[[], float]] = None):
        import time as _time
        from contextlib import nullcontext
        self.stepper = stepper
        self.workload = stepper.workload
        self.n_slots = int(stepper.n_slots)
        self.prefill_group = prefill_group
        self.decode_group = decode_group
        self.prefill_locks = list(prefill_locks or [])
        self.step_locks = list(step_locks or [])
        self._resolve = resolve
        self._reject = reject
        self._prefill_ctx = prefill_ctx or (lambda: nullcontext())
        self._step_ctx = step_ctx or (lambda: nullcontext())
        self._should_yield = should_yield
        self._yield_max_s = max(float(yield_max_s), 0.0)
        self._hooks = dict(hooks or {})
        self._clock = clock or _time.monotonic
        self._rec = get_recorder()
        self._track = f"engine:{_safe(self.workload)}"
        self._cv = threading.Condition()
        self._inbox: collections.deque = collections.deque()
        self._ready: collections.deque = collections.deque()
        self._free: List[int] = list(range(self.n_slots))[::-1]
        self._live: Dict[int, _Row] = {}
        self._stop = False
        self.steps = 0
        self.joins = 0
        self.evictions = 0
        self.cancellations = 0
        self.preemptions = 0
        self.max_live = 0
        with self._step_ctx():
            self._state = stepper.init_slots()
        self._threads = [
            threading.Thread(target=self._prefill_loop, daemon=True,
                             name=f"serve-cb-{_safe(self.workload)}-prefill"),
            threading.Thread(target=self._step_loop, daemon=True,
                             name=f"serve-cb-{_safe(self.workload)}-step"),
        ]
        for t in self._threads:
            t.start()
        _LIVE.add(self)

    # ---- submission ------------------------------------------------------
    def submit(self, req, spec, t_start: float) -> bool:
        """Hand one request to the engine (False after shutdown)."""
        with self._cv:
            if self._stop:
                return False
            self._inbox.append(_Pending(req, spec, t_start))
            self._cv.notify_all()
        return True

    # ---- prefill lane ----------------------------------------------------
    def _prefill_loop(self) -> None:
        while True:
            with self._cv:
                while not self._inbox and not self._stop:
                    self._cv.wait()
                if self._stop and not self._inbox:
                    return
                pending = self._inbox.popleft()
            try:
                t_p0 = self._rec.now()
                for lk in self.prefill_locks:
                    lk.acquire()
                try:
                    with self._prefill_ctx():
                        rows = self.stepper.prefill(pending.spec)
                finally:
                    for lk in reversed(self.prefill_locks):
                        lk.release()
                self._rec.complete(
                    "prefill", "engine", t_p0, self._rec.now(),
                    self._track,
                    getattr(pending.req, "trace_id", None),
                    workload=self.workload, group=self.prefill_group)
                pending.req.future.meta.setdefault(
                    "t_first_token", self._clock())
                pending.req.future.meta.setdefault("engine", {
                    "prefill_group": self.prefill_group,
                    "decode_group": self.decode_group})
                pending.n_rows = len(rows)
                with self._cv:
                    for i, (row_state, first_out, n_steps) in enumerate(rows):
                        row = _Row(pending, i, first_out, n_steps)
                        self._ready.append((row, row_state))
                    self._cv.notify_all()
            except BaseException as exc:          # noqa: BLE001
                self._reject(pending.req, exc)

    # ---- decode lane -----------------------------------------------------
    def _step_loop(self) -> None:
        while True:
            joined, evicted, cancelled = [], [], []
            with self._cv:
                while (not self._ready and not self._live
                       and not self._stop):
                    self._cv.wait()
                if self._stop and not self._ready and not self._live:
                    return
                # join at the step boundary: fill free slots from ready
                while self._ready and self._free:
                    row, row_state = self._ready.popleft()
                    if row.pending.req.future.done():
                        # already resolved elsewhere (hedge winner,
                        # shutdown rejection): never takes a slot
                        self.cancellations += 1
                        cancelled.append(row)
                        continue
                    row.slot = self._free.pop()
                    self._live[row.slot] = row
                    joined.append((row, row_state))
                live_now = dict(self._live)
                self.max_live = max(self.max_live, len(live_now))
                if cancelled:
                    self._cv.notify_all()
            if cancelled:
                if self._rec.enabled:
                    for row in cancelled:
                        self._rec.instant(
                            "engine_cancel", "engine", self._track,
                            getattr(row.pending.req, "trace_id", None),
                            at="join")          # preempted before a slot
                if "on_cancel" in self._hooks:
                    self._hooks["on_cancel"](len(cancelled))
            cancelled = []
            if not live_now:
                continue

            self._maybe_yield(live_now)
            t_s0 = self._rec.now()
            for lk in self.step_locks:
                lk.acquire()
            try:
                with self._step_ctx():
                    for row, row_state in joined:
                        self._state = self.stepper.insert(
                            self._state, row.slot, row_state)
                        self.joins += 1
                    self._state, outs = self.stepper.step(self._state)
                self.steps += 1
            except BaseException as exc:          # noqa: BLE001
                # a failed insert or step fails every live row's request
                # (never a dead thread that leaves their futures pending)
                self._fail_live(live_now, exc)
                continue
            finally:
                for lk in reversed(self.step_locks):
                    lk.release()
            # span covers lock wait too: lane contention is exactly
            # what a step timeline should show
            self._rec.complete("engine_step", "engine", t_s0,
                               self._rec.now(), self._track,
                               n_live=len(live_now), joins=len(joined),
                               group=self.decode_group)
            if joined:
                if self._rec.enabled:
                    for row, _ in joined:
                        self._rec.instant(
                            "engine_join", "engine", self._track,
                            getattr(row.pending.req, "trace_id", None),
                            slot=row.slot)
                if "on_join" in self._hooks:
                    self._hooks["on_join"](len(joined))
            if "on_step" in self._hooks:
                self._hooks["on_step"](len(live_now))

            for slot, row in live_now.items():
                if row.pending.req.future.done():
                    # hedge loser / cancelled mid-decode: free the slot
                    # at this boundary, skip finish (resolve-exactly-
                    # once makes the duplicate's value the only value)
                    cancelled.append(row)
                    continue
                if outs is not None:
                    row.collected.append(outs[slot])
                row.remaining -= 1
                if row.remaining <= 0:
                    evicted.append(row)
            if not evicted and not cancelled:
                continue
            with self._cv:
                for row in evicted:
                    del self._live[row.slot]
                    self._free.append(row.slot)
                    self.evictions += 1
                for row in cancelled:
                    del self._live[row.slot]
                    self._free.append(row.slot)
                    self.cancellations += 1
                self._cv.notify_all()
            if self._rec.enabled:
                for row in evicted:
                    self._rec.instant(
                        "engine_evict", "engine", self._track,
                        getattr(row.pending.req, "trace_id", None),
                        slot=row.slot)
                for row in cancelled:
                    self._rec.instant(
                        "engine_cancel", "engine", self._track,
                        getattr(row.pending.req, "trace_id", None),
                        at="mid_decode")        # preempted from a slot
            if evicted and "on_evict" in self._hooks:
                self._hooks["on_evict"](len(evicted))
            if cancelled and "on_cancel" in self._hooks:
                self._hooks["on_cancel"](len(cancelled))
            for row in evicted:
                self._finish_row(row)

    def _fail_live(self, live_now: Dict[int, _Row],
                   exc: BaseException) -> None:
        """Reject the requests of the rows a failed step held and free
        their slots."""
        with self._cv:
            for slot in live_now:
                self._live.pop(slot, None)
                self._free.append(slot)
            self._cv.notify_all()
        for req in {id(r.pending.req): r.pending.req
                    for r in live_now.values()}.values():
            self._reject(req, exc)

    def _maybe_yield(self, live_now: Dict[int, _Row]) -> None:
        """Iteration-boundary preemption: pause (bounded) while the
        Scheduler has latency-class deadline work waiting for this
        engine's lane — the waiting lane worker wins the lock handoff
        instead of racing the step loop for it.  Skipped when a live
        row is itself latency-class."""
        check = self._should_yield
        if check is None or not check():
            return
        if any(getattr(row.pending.req, "slo_class", "") == "latency"
               for row in live_now.values()):
            return
        self.preemptions += 1
        if self._rec.enabled:
            self._rec.instant("engine_preempt", "engine", self._track,
                              n_live=len(live_now))
        if "on_preempt" in self._hooks:
            self._hooks["on_preempt"](1)
        deadline = time.monotonic() + self._yield_max_s
        while check() and time.monotonic() < deadline:
            with self._cv:
                if self._stop:
                    return
            # urgent work clears once its lane worker HOLDS the locks
            # (scheduler._lane_run) — a short sleep is the handoff; the
            # deadline bounds livelock if the urgent lane died instead
            time.sleep(0.001)

    def _finish_row(self, row: _Row) -> None:
        pending = row.pending
        try:
            value = self.stepper.finish(self._state, row.slot,
                                        row.first_out, row.collected)
            pending.row_values[row.row_index] = value
            if len(pending.row_values) < pending.n_rows:
                return
            out = self.stepper.assemble(
                [pending.row_values[i] for i in range(pending.n_rows)])
            pending.req.future.meta.setdefault("t_last_token", self._clock())
            self._resolve(pending.req, out, pending.t_start)
        except BaseException as exc:              # noqa: BLE001
            self._reject(pending.req, exc)

    # ---- lifecycle -------------------------------------------------------
    @property
    def live_rows(self) -> int:
        with self._cv:
            return len(self._live)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until no work is queued or live (tests/benchmarks)."""
        deadline = self._clock() + timeout
        with self._cv:
            while (self._inbox or self._ready or self._live):
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def shutdown(self, timeout: float = 10.0) -> None:
        """Finish in-flight rows, then stop both threads."""
        with self._cv:
            if self._stop:
                self._cv.notify_all()
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout)

    def snapshot(self) -> Dict[str, object]:
        with self._cv:
            return {"workload": self.workload, "steps": self.steps,
                    "joins": self.joins, "evictions": self.evictions,
                    "cancellations": self.cancellations,
                    "preemptions": self.preemptions,
                    "max_live": self.max_live, "live": len(self._live),
                    "prefill_group": self.prefill_group,
                    "decode_group": self.decode_group}


def _safe(name: str) -> str:
    return name.replace("/", "-").replace("@", "-")


# ---------------------------------------------------------------------------
# Steppers
# ---------------------------------------------------------------------------
def _tree_map(fn, *trees):
    """``fn`` over the tensors of same-shaped trees of dicts, lists and
    tuples (the first tree's structure)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _check_lane(what: str, device) -> None:
    """The slot state lives on the decode lane's device: a lane on
    another device is a misplaced engine, never a silent copy."""
    lane = current_device()
    if str(lane) != str(device):
        raise RuntimeError(f"{what}: the slot state is on {device}, the "
                           f"calling lane on {lane}")


def _put_row(full, slot: int, row) -> None:
    """Write one row into slot ``slot`` of every slot-state tensor, in
    place; a row from the other device is copied here, once."""
    _tree_map(lambda f, r: f[slot].copy_(r), full, row)


class LMStepper:
    """Slot-batched LM decode over ``serve_step.make_slot_step``.

    One row == one prompt row of a request; the slot state is exactly
    the cache tree a size-S prefill produces (batch axis 0 on every
    layer's ``k`` / ``v``), so insert/step are in-place row writes and
    every slot decodes the same math it would decode alone.  ``finish``
    rebuilds the solo ``generate`` output: first prefill token + one
    token per step, (1, n_new + 1) int32 a row, on the CPU.

    Each lane runs on its own device from that device's copy of the
    weights (``workloads.requests.WeightCopies``: ``params`` serves its
    own device, a copy is made here, once, for every other device in
    ``devices``).  A lane whose device has no copy raises.  ``tp`` is
    the model-parallel degree the slots' K/V heads are repeated for.
    """

    def __init__(self, cfg, params, *, prompt_len: int, new_tokens: int,
                 cache_len: Optional[int] = None, n_slots: int = 4,
                 tp: int = 1, workload: str = "", devices=()):
        from repro_torch.core import cost_model
        from repro_torch.models.param import count_params
        from repro_torch.serve.serve_step import make_slot_step
        from repro_torch.workloads.requests import WeightCopies

        self.cfg = cfg
        self.prompt_len = int(prompt_len)
        self.new_tokens = int(new_tokens)
        self.cache_len = int(cache_len or (prompt_len + new_tokens + 1))
        self.n_slots = int(n_slots)
        self.tp = int(tp)
        self.workload = workload or f"serve-lm-cb/{cfg.name}"
        self._copies = WeightCopies(params, devices, owner=self.workload)
        self.weights = self._copies.on
        n_params = float(count_params(params))
        self.n_params = n_params
        self.prefill_cost = cost_model.lm_prefill_terms(
            n_params, self.prompt_len)
        self.decode_cost = cost_model.lm_decode_terms(n_params)
        self._slot_step = make_slot_step(cfg, tp=self.tp)

    def _prefill(self, prompt):
        """(first (B,) int32, caches) of one prefill on ``prompt``'s
        device, the reference's jitted ``_prefill``."""
        from repro_torch.models import model_zoo

        with torch.inference_mode():
            logits, caches = model_zoo.prefill(
                self.cfg, self.weights(prompt.device), {"tokens": prompt},
                cache_len=self.cache_len, tp=self.tp)
            first = torch.argmax(logits[:, -1].float(), dim=-1)
        return first.to(torch.int32), caches

    # -- protocol ----------------------------------------------------------
    def init_slots(self):
        dev = current_device()
        zeros = torch.zeros((self.n_slots, self.prompt_len),
                            dtype=torch.long, device=dev)
        _, caches = self._prefill(zeros)
        return {"caches": caches,
                "tokens": torch.zeros((self.n_slots,), dtype=torch.int32,
                                      device=dev),
                "pos": torch.zeros((self.n_slots,), dtype=torch.long,
                                   device=dev),
                "device": dev}

    def prefill(self, spec):
        prompt = spec.arrays[0].on(current_device())[0]
        first, caches = self._prefill(prompt)
        first_host = [int(t) for t in first.tolist()]   # waits for it
        rows = []
        for b in range(prompt.shape[0]):
            row_cache = _tree_map(lambda a, b=b: a[b], caches)
            rows.append(((row_cache, first[b]), first_host[b],
                         self.new_tokens))
        return rows

    def insert(self, state, slot, row_state):
        _check_lane(f"{self.workload} insert", state["device"])
        row_cache, first = row_state
        with torch.inference_mode():
            _put_row(state["caches"], slot, row_cache)
            state["tokens"][slot] = first.to(state["device"])
            state["pos"][slot] = self.prompt_len
        return state

    def step(self, state):
        _check_lane(f"{self.workload} step", state["device"])
        toks, caches = self._slot_step(self.weights(state["device"]),
                                       state["tokens"], state["caches"],
                                       state["pos"])
        state["caches"], state["tokens"] = caches, toks
        # dead slots step on: their positions stop at the cache's last
        # slot (a live row's last step is at prompt_len + new_tokens - 1)
        state["pos"] = torch.clamp(state["pos"] + 1, max=self.cache_len - 1)
        return state, toks.cpu().numpy()

    def finish(self, state, slot, first_out, collected):
        return torch.tensor([[first_out] + [int(t) for t in collected]],
                            dtype=torch.int32)

    def assemble(self, row_values):
        return torch.cat(row_values, dim=0)

    def warm(self, batch_sizes=(1, 2)) -> None:
        """Run the fixed slot shapes (size-S prefill, per-request prefill
        batches, insert, slot step) once on every device that holds the
        weights, ahead of traffic: first-use costs (kernel builds, the
        caching allocator's growth) are paid here."""
        for name in self._copies.devices:
            dev = torch.device(name)
            with lane_device(dev):
                state = self.init_slots()
                for b in batch_sizes:
                    first, caches = self._prefill(torch.zeros(
                        (int(b), self.prompt_len), dtype=torch.long,
                        device=dev))
                    row = _tree_map(lambda a: a[0], caches)
                    state = self.insert(state, 0, (row, first[0]))
                self.step(state)
                sync_device(dev)


class IterStepper:
    """Slot-batched iteration for sequential single-unit workloads.

    Wraps one per-row iteration (a pointer-jump round, a BGK step, a
    dither wavefront step) applied to a state with a leading slot axis:
    requests whose whole-job adapters were unpreemptible single units
    become sequences of step-boundary yield points, and same-shape
    requests stack into the one batched call.  The carried state IS the
    output: per-step ``outs`` is None and ``finish`` slices the final
    state at the row's slot.

    ``iter_fn(state) -> state`` is the batched iteration (the caller's
    ``torch.func.vmap`` of a per-row step, or a step written batched);
    ``template_row(device)`` a zero row state; ``make_rows(spec) ->
    [(row_state, n_steps), ...]`` builds the initial carried state per
    request row on the calling lane's device; ``finalize(row_state)``
    turns a final row state (a view into the slot state) into the
    request's value, which must match the solo adapter bit-for-bit.
    """

    def __init__(self, *, workload: str, n_slots: int, template_row,
                 iter_fn, make_rows, finalize,
                 prefill_cost=None, decode_cost=None,
                 assemble=None):
        from repro_torch.core.cost_model import CostTerms

        self.workload = workload
        self.n_slots = int(n_slots)
        self._template = template_row
        self._make_rows = make_rows
        self._finalize = finalize
        self._assemble = assemble
        self.prefill_cost = prefill_cost or CostTerms()
        self.decode_cost = decode_cost or CostTerms()
        self._step = iter_fn

    def init_slots(self):
        dev = current_device()
        return {"rows": _tree_map(
            lambda a: torch.zeros((self.n_slots,) + tuple(a.shape),
                                  dtype=a.dtype, device=dev),
            self._template(dev)), "device": dev}

    def prefill(self, spec):
        return [(row_state, None, n_steps)
                for row_state, n_steps in self._make_rows(spec)]

    def insert(self, state, slot, row_state):
        _check_lane(f"{self.workload} insert", state["device"])
        _put_row(state["rows"], slot, row_state)
        return state

    def step(self, state):
        _check_lane(f"{self.workload} step", state["device"])
        state["rows"] = self._step(state["rows"])
        # done on the lane's stream before the boundary: finish() reads
        # the state from the engine's thread outside the lane
        sync_device(state["device"])
        return state, None

    def finish(self, state, slot, first_out, collected):
        row = _tree_map(lambda a: a[slot], state["rows"])
        return self._finalize(row)

    def assemble(self, row_values):
        if self._assemble is not None:
            return self._assemble(row_values)
        return row_values[0] if len(row_values) == 1 else row_values

    def warm(self) -> None:
        """Run insert + the batched step once, ahead of traffic."""
        state = self.init_slots()
        state = self.insert(state, 0, self._template(state["device"]))
        self.step(state)
