"""The measured window: the program's serving path driven by the traffic
schedule, and what it returned.

The entry the window drives is ``repro_torch.serve.scheduler.Scheduler``
over the accelerator's group alone, with the continuous LM adapter of
``workloads.requests`` registered on it; every request is one prompt of
the schedule, handed in as ``payload["prompt"]``.  Times are read on the
scheduler's clock, the clock the engine stamps its tokens with.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

DRAIN_S = 60.0            # how long past the close a request is waited for


@dataclass
class Record:
    index: int
    due: float                     # when it was due, scheduler clock
    sent: float = 0.0              # when it was submitted
    future: object = None
    done_at: Optional[float] = None
    ok: bool = False
    tokens: Optional[torch.Tensor] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    error: str = ""


@dataclass
class Calls:
    """The wrapped stepper calls of a traced run: (start, end, key) of
    each prefill (key: the prompt's first ids) and (start, end) of each
    step, on the scheduler's clock."""
    prefills: List[Tuple[float, float, tuple]] = field(default_factory=list)
    steps: List[Tuple[float, float]] = field(default_factory=list)


def prompt_key(prompt) -> tuple:
    return tuple(int(t) for t in prompt.reshape(-1)[:16].tolist())


def wrap_stepper(stepper, clock: Callable[[], float]) -> Calls:
    """Time the stepper's prefill and step, each inside a
    ``record_function`` range; both end on a host synchronisation (the
    prefill reads its first token, the step its tokens)."""
    from torch.profiler import record_function

    calls = Calls()
    prefill, step = stepper.prefill, stepper.step

    def timed_prefill(spec):
        key = prompt_key(spec.arrays[0].host[0])
        t0 = clock()
        with record_function("bench.prefill"):
            out = prefill(spec)
        calls.prefills.append((t0, clock(), key))
        return out

    def timed_step(state):
        t0 = clock()
        with record_function("bench.step"):
            out = step(state)
        calls.steps.append((t0, clock()))
        return out

    stepper.prefill, stepper.step = timed_prefill, timed_step
    return calls


class Served:
    """The program under test, set up for one cell: weights on the
    device, the adapter registered, the scheduler over the accelerator's
    group, every shape of the cell's traffic warmed."""

    def __init__(self, cfg, params, *, prompt_len: int, new_tokens: int,
                 n_slots: int, name: str, group=None):
        from repro_torch.core.hybrid_executor import detect_platform
        from repro_torch.serve.scheduler import Scheduler
        from repro_torch.workloads import requests as adapters

        self.adapters = adapters
        self.wl = adapters.make_continuous_lm_adapter(
            cfg, params, prompt_len=prompt_len, new_tokens=new_tokens,
            n_slots=n_slots, warm_background=False, name=name)
        adapters.wait_precompiled(timeout=600)
        self.stepper = adapters.make_request(self.wl, {"batch": 1}).stepper
        if group is None:
            group = detect_platform()[0][0]
        self.sched = Scheduler(groups=[group])
        self.clock = self.sched.clock

    def submit(self, prompt) -> object:
        return self.sched.submit(self.wl, {"prompt": prompt})

    def warm(self, prompts) -> None:
        """The cell's own shapes, once: the engine's slot state (its
        size-S prefill), the batch-1 prefill, and the slot step with
        every slot live and a prefill waiting."""
        futs = [self.submit(p) for p in prompts]
        for f in futs:
            f.result(timeout=1200)

    def close(self) -> None:
        self.sched.shutdown()
        self.adapters.unregister(self.wl)
        self.stepper = None


def run_window(served: Served, schedule, seconds: float,
               at: Optional[Dict[float, Callable[[], None]]] = None
               ) -> Tuple[List[Record], float, float, List[float]]:
    """Offer the schedule for ``seconds`` from a thread of its own and
    wait for what it sent, up to ``DRAIN_S`` past the close.  ``at`` maps
    seconds from the start to calls made then on this thread (the
    profiler's start and stop), so that they never delay a submission.
    Returns (records, start, close, the open loop's lateness)."""
    clock = served.clock
    records: List[Record] = []
    lateness: List[float] = []
    returned: "queue.Queue[int]" = queue.Queue()
    errors: List[BaseException] = []

    def send(i: int, due: float, client: int) -> None:
        r = Record(index=i, due=due)
        r.sent = clock()
        r.future = served.submit(schedule.prompts[i])
        records.append(r)

        def stamp(f, r=r):
            r.done_at = clock()
            returned.put(client)

        r.future.add_done_callback(stamp)

    def sleep_until(t: float) -> None:
        while clock() < t:
            time.sleep(max(0.0, t - clock()))

    def drive() -> None:
        try:
            if schedule.loop == "open":
                for i, d in enumerate(schedule.due):
                    sleep_until(t0 + d)
                    send(i, t0 + d, 0)
                    lateness.append(records[-1].sent - (t0 + d))
                return
            nxt = 0
            for c in range(schedule.clients):
                send(nxt, clock(), c)
                nxt += 1
            while True:
                left = close - clock()
                if left <= 0:
                    return
                try:
                    c = returned.get(timeout=left)
                except queue.Empty:
                    return
                if clock() >= close:
                    return
                if nxt >= len(schedule.prompts):
                    raise RuntimeError("the closed loop ran out of prompts: "
                                       "raise the traffic's pool_per_s")
                send(nxt, clock(), c)
                nxt += 1
        except BaseException as exc:       # noqa: BLE001 - re-raised below
            errors.append(exc)

    t0 = clock()
    close = t0 + seconds
    driver = threading.Thread(target=drive, name="bench-traffic")
    driver.start()
    for when, fn in sorted((at or {}).items()):
        sleep_until(t0 + when)
        fn()
    sleep_until(close)
    driver.join()
    if errors:
        raise errors[0]
    for r in records:
        try:
            r.tokens = r.future.result(timeout=max(close + DRAIN_S - clock(),
                                                   0.0))
            r.ok = True
        except Exception as exc:           # noqa: BLE001 - recorded per request
            r.error = f"{type(exc).__name__}: {exc}"[:300]
        r.t_first = r.future.meta.get("t_first_token")
        r.t_last = r.future.meta.get("t_last_token")
    return records, t0, close, lateness
