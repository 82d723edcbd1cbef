"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the window, reduced to the device's busy intervals and its kernels.

The profiler records host operations only on the thread that starts it
(here the benchmark's own), and the device's kernels, copies and
memsets of every thread.  Marks made on this thread at known times of
the scheduler's clock tie the profiler's clock to it, so that a kernel
can be placed inside a wrapped stepper call timed on the engine's
threads.  A stretch whose trace holds no device event at all is a
trace the profiler lost, not an idle card: it reads as no trace, and
the metrics that need one are left out of the result.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

MARK = "bench.mark"


@dataclass
class DeviceTrace:
    start: float                   # the stretch, scheduler clock
    end: float
    # (name, start, end) of every kernel, copy and memset, scheduler clock
    ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self, lo: Optional[float] = None,
             hi: Optional[float] = None) -> float:
        """Seconds in [lo, hi] (default: the stretch) in which at least
        one operation ran on the device."""
        lo = self.start if lo is None else lo
        hi = self.end if hi is None else hi
        return union(clip(self.ops, lo, hi))

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The stretch's intervals with no device operation running."""
        gaps, t = [], self.start
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if a > t:
                gaps.append((t, min(a, self.end)))
            t = max(t, b)
            if t >= self.end:
                break
        if t < self.end:
            gaps.append((t, self.end))
        return gaps


def idle_share(ctx) -> Optional[float]:
    """The device's idle share over a traced run's profiled stretch: 1 -
    the union of its kernels', copies' and memsets' intervals / the
    stretch; None without a trace."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy() / tr.window_s


def clip(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for _, a, b in ops
            if min(b, hi) > max(a, lo)]


def union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Profiler:
    """Start and stop ``torch.profiler`` from this thread; ``result()``
    gives the stretch's ``DeviceTrace`` (None where the profiler kept no
    device event)."""

    def __init__(self, clock: Callable[[], float], stretch: float):
        self.clock = clock
        self.stretch = stretch
        self.prof = None
        self.marks: List[Tuple[float, float]] = []
        self.t_start = self.t_end = 0.0

    def _mark(self) -> None:
        from torch.profiler import record_function

        h0 = self.clock()
        with record_function(MARK):
            pass
        self.marks.append((h0, self.clock()))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = self.clock()
        for _ in range(3):
            self._mark()

    def stop(self) -> None:
        """End the stretch ``stretch`` seconds after the profiler came up
        (its start can take seconds while the engine runs)."""
        if self.prof is None or self.t_end:
            return
        while self.clock() < self.t_start + self.stretch:
            time.sleep(self.t_start + self.stretch - self.clock())
        for _ in range(3):
            self._mark()
        self.t_end = self.clock()
        self.prof.stop()

    def result(self) -> Optional[DeviceTrace]:
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in events if e.name() == MARK
                       and e.device_type() == DeviceType.CPU)
        if len(marks) != len(self.marks):
            raise RuntimeError(f"profiler kept {len(marks)} of "
                               f"{len(self.marks)} marks")
        # scheduler clock = profiler ns * 1e-9 + offset; each mark's
        # profiled range lies inside its host range: take the tightest
        offsets = sorted(((h1 - h0), (h0 + h1) / 2 - (a + b) / 2e9)
                         for (h0, h1), (a, b) in zip(self.marks, marks))
        off = offsets[0][1]
        ops = []
        for e in events:
            if e.device_type() != DeviceType.CUDA or e.name() == MARK \
                    or e.is_user_annotation() or e.name().startswith("bench."):
                continue
            a = e.start_ns() * 1e-9 + off
            ops.append((e.name(), a, a + e.duration_ns() * 1e-9))
        self.prof = None
        if not ops:
            return None
        return DeviceTrace(self.t_start, self.t_end, ops)
