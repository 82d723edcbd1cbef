"""Low-overhead ring-buffer span recorder with Chrome-trace export.

Design constraints (see obs/README.md for the span taxonomy):

* **Cheap when off.**  ``REPRO_TRACE=0`` turns every record call into a
  single attribute check + early return; nothing is allocated, no lock
  is taken.  The overhead contract the bench gates on (traced p50 <=
  1.05x untraced) only holds because the *on* path is also tiny: one
  dict build + deque append under a lock.
* **Bounded memory.**  Events land in a ``deque(maxlen=REPRO_TRACE_BUF)``
  (default 65536): a week-long serving run can leave tracing on and the
  buffer stays a ring, dropping the oldest spans.
* **Cross-process stitchable.**  Timestamps are wall-anchored: each
  recorder captures ``time.time() - time.monotonic()`` once at init and
  stamps events with ``(anchor + monotonic) * 1e6`` microseconds.
  Durations come purely from the monotonic clock (never walk
  backwards); absolute positions from different processes land on one
  shared timeline, so worker span batches shipped over heartbeats
  (``serve/transport.py``) merge into a single coherent export.
* **String tracks.**  Callers tag events with a free-form ``track``
  ("lane:cuda:0", "fw1/engine:lm", ...).  Export maps each distinct
  track to a (pid, tid) pair and emits Chrome ``M`` metadata events so
  the viewer shows named rows — one track per lane/worker.

Trace ids are pid-prefixed counters (``"12345-7"``): unique across the
fleet's worker processes without coordination.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in (
        "0", "false", "off", "no", "")


def trace_enabled() -> bool:
    """Process-level default for new recorders (``REPRO_TRACE``)."""
    return _env_flag("REPRO_TRACE", "1")


_trace_ids = itertools.count(1)


def new_trace_id() -> str:
    """Fleet-unique without coordination: pid-prefixed counter."""
    return f"{os.getpid()}-{next(_trace_ids)}"


class TraceRecorder:
    """Thread-safe ring buffer of Chrome-trace events.

    ``enabled`` is a plain attribute: flip it to compare traced vs
    untraced in-process (the bench's overhead row does exactly that).
    """

    def __init__(self, maxlen: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if maxlen is None:
            try:
                maxlen = int(os.environ.get("REPRO_TRACE_BUF", "65536"))
            except ValueError:
                maxlen = 65536
        self.enabled = trace_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(int(maxlen), 16))
        # wall-clock anchor: lets spans recorded in different processes
        # (each with its own monotonic epoch) share one exported timeline
        self._anchor = time.time() - time.monotonic()

    # -- recording ---------------------------------------------------
    def now(self) -> float:
        """Monotonic seconds — pair with ``complete(t0, t1)``."""
        return time.monotonic()

    def _ts_us(self, t_mono: float) -> float:
        return (self._anchor + t_mono) * 1e6

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 track: str, trace_id: Optional[str] = None,
                 **attrs) -> None:
        """Record a completed span: ``t0``/``t1`` monotonic seconds."""
        if not self.enabled:
            return
        args = attrs
        if trace_id is not None:
            args = dict(attrs, trace_id=trace_id)
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts_us(t0),
              "dur": max((t1 - t0) * 1e6, 0.0),
              "track": track, "args": args}
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str, track: str,
                trace_id: Optional[str] = None, **attrs) -> None:
        """Record a point event (watchdog kill, steal, chaos fault...)."""
        if not self.enabled:
            return
        args = attrs
        if trace_id is not None:
            args = dict(attrs, trace_id=trace_id)
        ev = {"name": name, "cat": cat, "ph": "i",
              "ts": self._ts_us(time.monotonic()),
              "track": track, "s": "t", "args": args}
        with self._lock:
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str, track: str,
             trace_id: Optional[str] = None, **attrs):
        """Context-manager form of ``complete`` for inline scopes."""
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.complete(name, cat, t0, time.monotonic(), track,
                          trace_id, **attrs)

    # -- shipping ----------------------------------------------------
    def drain(self) -> List[dict]:
        """Pop-and-return everything buffered (heartbeat shipping)."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    def ingest(self, events: Iterable[dict],
               track_prefix: str = "") -> None:
        """Append events recorded elsewhere (a worker's drained batch).

        Timestamps are already wall-anchored absolute microseconds, so
        no clock translation happens here — only a track re-tag so the
        export shows which worker each span ran on."""
        if not events:
            return
        with self._lock:
            for ev in events:
                if track_prefix:
                    ev = dict(ev,
                              track=f"{track_prefix}{ev.get('track', '?')}")
                self._events.append(ev)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[dict]:
        """Snapshot without clearing (tests, audits)."""
        with self._lock:
            return list(self._events)

    # -- export ------------------------------------------------------
    def export_chrome(self, path: str) -> int:
        """Write Chrome trace-event / Perfetto JSON; returns event count.

        Track strings map to (pid, tid): a ``"worker/"`` prefix (added
        by ``ingest``) becomes the process, the remainder the thread.
        ``M`` metadata events name both so the viewer shows one labeled
        row per lane/worker."""
        with self._lock:
            events = list(self._events)
        events.sort(key=lambda e: e["ts"])
        t0 = events[0]["ts"] if events else 0.0

        pids: Dict[str, int] = {}
        tids: Dict[str, int] = {}
        out: List[dict] = []

        def _ids(track: str):
            proc, _, lane = track.rpartition("/")
            proc = proc or "serve"
            lane = lane or "?"
            if proc not in pids:
                pids[proc] = len(pids) + 1
                out.append({"name": "process_name", "ph": "M",
                            "pid": pids[proc], "tid": 0,
                            "args": {"name": proc}})
            if track not in tids:
                tids[track] = len(tids) + 1
                out.append({"name": "thread_name", "ph": "M",
                            "pid": pids[proc], "tid": tids[track],
                            "args": {"name": lane}})
            return pids[proc], tids[track]

        for ev in events:
            pid, tid = _ids(ev.get("track", "?"))
            rec = {"name": ev["name"], "cat": ev.get("cat", "serve"),
                   "ph": ev["ph"], "ts": ev["ts"] - t0,
                   "pid": pid, "tid": tid,
                   "args": ev.get("args", {})}
            if ev["ph"] == "X":
                rec["dur"] = ev.get("dur", 0.0)
            elif ev["ph"] == "i":
                rec["s"] = ev.get("s", "t")
            out.append(rec)

        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return len(events)


_recorder: Optional[TraceRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> TraceRecorder:
    """Process-wide recorder singleton (workers drain it on heartbeat)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = TraceRecorder()
    return _recorder
