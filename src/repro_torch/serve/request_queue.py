"""Thread-safe bounded request queue for the serving scheduler.

The queue is the admission-control boundary of the serving subsystem
(ROADMAP: "serves heavy traffic"): depth is bounded, a full queue turns
submissions away *immediately* with a structured ``Rejection`` (clients
must see backpressure, not an unbounded latency tail), and requests
whose deadline has already passed are shed at pop time with the same
structured rejection instead of burning device time on work nobody is
waiting for.

``ServeFuture`` is deliberately minimal: resolve-exactly-once
semantics (``drain()`` depends on it — a future resolved twice would
mean a request executed twice or a result overwritten), blocking
``result(timeout)``, and done-callbacks for latency accounting.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

# SLO classes (scenario engine / class-aware admission).  ``latency``
# requests are deadline-sensitive: projected-miss work sheds at
# admission and their arrival can preempt batch work at the continuous
# engine's iteration boundaries.  ``batch`` requests queue through
# pressure (a late batch result is still a result).  ``best_effort``
# is shed first under brownout.
SLO_LATENCY = "latency"
SLO_BATCH = "batch"
SLO_BEST_EFFORT = "best_effort"
SLO_CLASSES = (SLO_LATENCY, SLO_BATCH, SLO_BEST_EFFORT)


def resolve_slo_class(slo_class: Optional[str], priority: int,
                      deadline_s: Optional[float],
                      hedge: bool) -> str:
    """Explicit class wins; otherwise derive the pre-SLO semantics so
    existing callers keep their behavior: ``priority < 0`` was always
    best-effort (brownout shed), a deadline or a hedge marks the
    request latency-sensitive, everything else is batch work."""
    if slo_class is not None:
        if slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo_class!r}; "
                             f"expected one of {SLO_CLASSES}")
        return slo_class
    if priority < 0:
        return SLO_BEST_EFFORT
    if deadline_s is not None or hedge:
        return SLO_LATENCY
    return SLO_BATCH


@dataclass(frozen=True)
class Rejection:
    """Structured admission-control verdict attached to a rejected
    future: ``reason`` is machine-readable ("queue_full" | "deadline" |
    "shutdown" | "lane_failure" | "brownout" | "worker_failure" — the
    last issued by the fleet router when a whole worker process dies
    and the resubmit budget is spent), the rest is enough
    context for a client to back off intelligently (retry after the
    queue drains vs drop the request vs downgrade to best-effort
    later)."""
    reason: str
    workload: str
    detail: str = ""
    queue_depth: int = 0
    deadline_s: Optional[float] = None
    waited_s: float = 0.0


class RequestRejected(RuntimeError):
    """Raised from ``Future.result()`` for a rejected request."""

    def __init__(self, rejection: Rejection):
        super().__init__(f"request rejected ({rejection.reason}): "
                         f"{rejection.workload} {rejection.detail}")
        self.rejection = rejection


class ServeFuture:
    """Resolve-exactly-once future.

    ``_resolve``/``_reject`` return True only for the call that
    actually transitioned the future — the scheduler asserts on that in
    ``drain()`` so a double-resolution bug fails loudly instead of
    silently overwriting a client's result."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["ServeFuture"], None]] = []
        # free-form per-request stamps (TTFT, decode span, placement);
        # written by the executing lane/engine BEFORE the future
        # resolves, read by clients after — no lock needed
        self.meta: dict = {}

    def done(self) -> bool:
        return self._event.is_set()

    def _finish(self, value, exc) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._exc = exc
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for cb in callbacks:
            cb(self)
        return True

    def _resolve(self, value) -> bool:
        return self._finish(value, None)

    def _reject(self, exc: BaseException) -> bool:
        return self._finish(None, exc)

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        return self._exc

    def add_done_callback(self, cb: Callable[["ServeFuture"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)


_req_ids = itertools.count()


@dataclass(order=True)
class Request:
    """One queued serving request.  Orders by (-priority, seq): higher
    ``priority`` pops first, FIFO within a priority level."""
    sort_key: tuple = field(init=False, repr=False)
    workload: str = field(compare=False)
    payload: object = field(compare=False)
    priority: int = field(compare=False, default=0)
    deadline_s: Optional[float] = field(compare=False, default=None)
    t_submit: float = field(compare=False, default=0.0)
    t_deadline: Optional[float] = field(compare=False, default=None)
    bucket: str = field(compare=False, default="")
    n_units: int = field(compare=False, default=1)
    req_id: int = field(compare=False, default_factory=lambda: next(_req_ids))
    future: ServeFuture = field(compare=False, default_factory=ServeFuture)
    # fault-tolerance state (scheduler-owned, mutated under its lock):
    retries: int = field(compare=False, default=0)
    hedge: bool = field(compare=False, default=False)
    #                     latency-sensitive: eligible for duplication
    hedged: bool = field(compare=False, default=False)
    #                     a duplicate execution has been launched
    # observability: fleet-unique trace id (repro_torch.obs) — survives
    # requeues, hedges and router resubmits across fresh req_ids, so
    # one exported trace stitches a request's whole path
    trace_id: Optional[str] = field(compare=False, default=None)
    # SLO class: admission, brownout ordering and engine preemption
    # key off it (see resolve_slo_class for the derivation defaults)
    slo_class: str = field(compare=False, default=SLO_BATCH)

    def __post_init__(self):
        self.sort_key = (-self.priority, self.req_id)

    def reject(self, rejection: Rejection) -> bool:
        return self.future._reject(RequestRejected(rejection))


class RequestQueue:
    """Bounded thread-safe priority queue with deadline shedding.

    ``push`` never blocks: a full queue is an immediate structured
    rejection (the caller resolves the future), because blocking the
    submitter just moves the unbounded queue into the clients.
    ``pop`` sheds requests whose deadline already passed — their
    futures are rejected here, exactly once, so an expired request can
    never hang its client."""

    def __init__(self, max_depth: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self.max_depth = max(int(max_depth), 1)
        self.clock = clock
        self._heap: List[Request] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def close(self) -> None:
        """Wake every popper; subsequent pushes are rejected."""
        with self._not_empty:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def push(self, req: Request, requeue: bool = False
             ) -> Optional[Rejection]:
        """Enqueue, or return the structured rejection (future already
        rejected) when the queue is full or closed.

        ``requeue=True`` is the scheduler's retry path: a request whose
        lane failed re-enters even after ``close()`` — drain() promised
        its future a resolution, and the retry *is* that resolution.
        The depth bound still applies (retries must not grow the queue
        unboundedly either)."""
        with self._not_empty:
            if self._closed and not requeue:
                rej = Rejection("shutdown", req.workload,
                                detail="scheduler is draining or shut down")
            elif len(self._heap) >= self.max_depth:
                rej = Rejection("queue_full", req.workload,
                                detail=f"depth {len(self._heap)} >= "
                                       f"{self.max_depth}",
                                queue_depth=len(self._heap))
            else:
                heapq.heappush(self._heap, req)
                self._not_empty.notify()
                return None
        req.reject(rej)
        return rej

    def _shed_expired_locked(self, now: float) -> List[Request]:
        shed, keep = [], []
        for r in self._heap:
            if r.t_deadline is not None and now > r.t_deadline:
                shed.append(r)
            else:
                keep.append(r)
        if shed:
            heapq.heapify(keep)
            self._heap = keep
        return shed

    def pop(self, timeout: Optional[float] = None
            ) -> tuple:
        """(request | None, shed) — ``shed`` lists requests dropped for
        expired deadlines this call (already rejected).  None when the
        queue stayed empty for ``timeout`` or was closed."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._not_empty:
            while True:
                shed = self._shed_expired_locked(self.clock())
                if shed:
                    break
                if self._heap:
                    break
                if self._closed:
                    break
                wait = (None if deadline is None
                        else deadline - self.clock())
                if wait is not None and wait <= 0:
                    break
                self._not_empty.wait(wait)
            req = heapq.heappop(self._heap) if self._heap else None
        for r in shed:
            r.reject(Rejection(
                "deadline", r.workload,
                detail=f"deadline {r.deadline_s:.4f}s passed while queued",
                deadline_s=r.deadline_s,
                waited_s=self.clock() - r.t_submit))
        return req, shed

    def pop_matching(self, workload: str, bucket: str, limit: int
                     ) -> List[Request]:
        """Pop up to ``limit`` queued requests with the same
        (workload, shape-bucket) — the batching coalescer.  Preserves
        priority order among the matches; non-matching requests keep
        their positions."""
        if limit <= 0:
            return []
        with self._lock:
            matches = sorted([r for r in self._heap
                              if r.workload == workload
                              and r.bucket == bucket])[:limit]
            if matches:
                taken = {id(r) for r in matches}
                self._heap = [r for r in self._heap
                              if id(r) not in taken]
                heapq.heapify(self._heap)
        return matches

    def drain_remaining(self) -> List[Request]:
        """Pop everything (shutdown path); caller decides whether to
        execute or reject."""
        with self._lock:
            out, self._heap = self._heap, []
        return sorted(out)
