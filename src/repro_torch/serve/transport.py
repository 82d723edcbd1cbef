"""Transport layer: request *arrival* split from Scheduler *dispatch*.

The ``Scheduler`` never cared where a request came from — ``submit()``
feeds a bounded ``RequestQueue`` and everything downstream (placement,
batching, lanes, fault tolerance) is transport-agnostic.  This module
makes the split explicit: a request travels as a small picklable
message, and a **worker** is anything that accepts ``SubmitMsg``es and
answers with ``ResultMsg``es plus periodic ``HeartbeatMsg``es.

Two worker transports ship today, same wire contract:

* ``InProcWorker`` — the scheduler lives in this process; messages are
  plain function calls (the "in-process queue today" path).  Used for
  transport-parity tests and single-process fleets.
* ``ProcWorker`` — the scheduler lives in a child **process** spawned
  from this module's ``--worker`` entry point; messages are
  length-prefixed pickles over a dedicated pipe pair (``pass_fds`` —
  stdout stays free for library chatter, so framing can never be
  corrupted by a stray print).  The child hosts a full ``Scheduler``
  over its own detected device groups (the GPU + CPU pair, a CUDA
  context of its own on the first GPU; ``device="cpu"`` the simulated
  pair on the CPU) and shares the merge-on-write
  calibration/tune ``JsonStore``s through ``REPRO_CALIB_CACHE`` /
  ``REPRO_TUNE_CACHE`` env (passed via ``env=``), so a worker that has
  never seen a workload still places it with zero probes — the
  cold-start contract at fleet granularity.

The router (``serve/router.py``) treats both identically: it only sees
``name``, ``start(on_result, on_heartbeat)``, ``submit(msg) -> bool``,
``transport_alive``, ``shutdown()`` — plus the chaos hooks ``kill()``
(SIGKILL), ``stall()``/``resume()`` (SIGSTOP/SIGCONT), ``slow()`` and
``restart()`` where the transport supports them.

Worker results are moved to the host before pickling (every
``torch.Tensor`` becomes ``.detach().cpu()``, a bf16 tensor a bf16 CPU
tensor: a CUDA tensor crossing the pipe would unpickle onto the
parent's own GPU), so in-process and subprocess transports return
bit-identical values for the same request — the parity tests in
``tests/test_torch_fleet.py`` gate exactly that.
"""
from __future__ import annotations

import argparse
import os
import pickle
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.serve.request_queue import Rejection, RequestRejected

_LEN = struct.Struct(">I")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# wire messages (picklable; defined at module scope so the child process
# unpickles them against the same class objects)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SubmitMsg:
    """One request on the wire.  ``deadline_s`` is *remaining* seconds
    (the router re-derives it from the absolute deadline on every
    resubmit, so a failover never extends a client's deadline)."""
    req_id: int
    workload: str
    payload: object = None
    deadline_s: Optional[float] = None
    priority: int = 0
    hedge: bool = False
    # SLO class ("latency" | "batch" | "best_effort"); None derives the
    # pre-SLO default worker-side (request_queue.resolve_slo_class)
    slo: Optional[str] = None
    # End-to-end trace correlation: the router mints one id per client
    # request and re-sends it on every failover resubmit, so spans from
    # different workers (and different req_ids) stitch into one story.
    trace_id: Optional[str] = None


@dataclass(frozen=True)
class ResultMsg:
    """The exactly-once answer for one ``SubmitMsg``.  ``ok`` with a
    value, or a structured ``rejection`` (passed through to the client
    verbatim), or an application ``error`` string."""
    req_id: int
    ok: bool
    value: object = None
    rejection: Optional[Rejection] = None
    error: Optional[str] = None


@dataclass(frozen=True)
class HeartbeatMsg:
    """Health/load report: ``load`` is the worker's live backlog
    (in-flight requests), ``stats`` a full ``ServeStats.snapshot()``
    (a child process adds ``cuda_memory_reserved`` and its kernel
    launches, ``launches.<kernel>`` and ``entry_launches.<entry>``).
    ``spans`` piggybacks the worker's drained trace events (plain
    dicts) so the router can stitch one fleet-wide timeline; an empty
    tuple when tracing is off or nothing happened since the last
    beat."""
    t: float
    load: float = 0.0
    stats: Dict[str, float] = field(default_factory=dict)
    spans: tuple = ()


@dataclass(frozen=True)
class PingMsg:
    """Ask the worker for an immediate heartbeat (stats refresh)."""


@dataclass(frozen=True)
class SlowMsg:
    """Chaos: executions for the next ``duration_s`` take ``factor`` x
    as long (the worker sleeps out the difference before answering)."""
    factor: float
    duration_s: float


@dataclass(frozen=True)
class ShutdownMsg:
    """Drain the worker's scheduler and exit cleanly."""


# ---------------------------------------------------------------------------
# framing + value portability
# ---------------------------------------------------------------------------
def _send_frame(wfile, obj) -> None:
    buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    wfile.write(_LEN.pack(len(buf)) + buf)
    wfile.flush()


def _recv_frame(rfile):
    head = rfile.read(_LEN.size)
    if len(head) < _LEN.size:
        raise EOFError("transport closed")
    (n,) = _LEN.unpack(head)
    buf = b""
    while len(buf) < n:
        part = rfile.read(n - len(buf))
        if not part:
            raise EOFError("transport closed mid-frame")
        buf += part
    return pickle.loads(buf)


def _portable(value):
    """Move every tensor in ``value`` (through tuples, lists and dicts)
    to the host, so a result survives pickling across a process
    boundary and compares bit-identically against the in-process
    transport.  Numpy arrays and other leaves pass as they are.  It
    catches nothing: a value it cannot move fails the request."""
    import torch
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _portable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_portable(v) for v in value]
    if isinstance(value, tuple):
        items = [_portable(v) for v in value]
        return (type(value)(*items) if hasattr(value, "_fields")
                else tuple(items))
    return value


def _result_for(req_id: int, fut) -> ResultMsg:
    """Fold a resolved ServeFuture into the wire message."""
    exc = fut.exception(timeout=0)
    if exc is None:
        try:
            value = _portable(fut.result(0))
        except Exception as e:                     # noqa: BLE001
            # the value cannot leave this process: the request fails
            # with the reason (a done-callback must not raise into the
            # scheduler lane that resolved it)
            return ResultMsg(req_id, ok=False,
                             error=f"result not portable: "
                                   f"{type(e).__name__}: {e}")
        return ResultMsg(req_id, ok=True, value=value)
    if isinstance(exc, RequestRejected):
        return ResultMsg(req_id, ok=False, rejection=exc.rejection)
    return ResultMsg(req_id, ok=False,
                     error=f"{type(exc).__name__}: {exc}")


# ---------------------------------------------------------------------------
# in-process worker (queue today)
# ---------------------------------------------------------------------------
class InProcWorker:
    """A fleet worker whose scheduler lives in this process.

    ``kill()`` simulates a process death at the transport boundary: the
    underlying scheduler keeps running but no message crosses it in
    either direction (exactly what the router observes of a SIGKILLed
    child before the OS reaps it), so router failover logic is testable
    without subprocess latency.  ``restart()`` reconnects.
    ``sched_factory`` makes the scheduler at ``start()``; the default is
    ``Scheduler()``, the GPU + CPU pair (raises without a GPU)."""

    def __init__(self, name: str,
                 sched_factory: Optional[Callable] = None,
                 hb_interval_s: Optional[float] = None):
        self.name = name
        self._sched_factory = sched_factory
        self.hb_interval_s = (hb_interval_s if hb_interval_s is not None
                              else _env_float("REPRO_FLEET_HB_S", 1.0))
        self._sched = None
        self._killed = False
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._on_result = None
        self._on_heartbeat = None
        self._slow_until = 0.0
        self._slow_factor = 1.0

    def start(self, on_result, on_heartbeat) -> None:
        self._on_result = on_result
        self._on_heartbeat = on_heartbeat
        if self._sched is None:
            if self._sched_factory is not None:
                self._sched = self._sched_factory()
            else:
                from repro_torch.serve.scheduler import Scheduler
                self._sched = Scheduler()
        if self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name=f"serve-fleet-hb-{self.name}",
                daemon=True)
            self._hb_thread.start()

    @property
    def transport_alive(self) -> bool:
        return not self._killed and self._sched is not None

    def _beat(self) -> None:
        if self._killed or self._sched is None:
            return
        st = self._sched.stats
        msg = HeartbeatMsg(time.monotonic(), load=float(st.in_flight),
                           stats=st.snapshot())
        cb = self._on_heartbeat
        if cb is not None:
            cb(self.name, msg)

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.hb_interval_s):
            self._beat()

    def ping(self) -> None:
        self._beat()

    def submit(self, msg: SubmitMsg) -> bool:
        if self._killed or self._sched is None:
            return False
        t0 = time.monotonic()
        # in-proc shares the global recorder with the router, so the
        # trace_id is all that needs forwarding (no span shipping)
        fut = self._sched.submit(msg.workload, msg.payload,
                                 deadline=msg.deadline_s,
                                 priority=msg.priority, hedge=msg.hedge,
                                 trace_id=msg.trace_id,
                                 slo_class=msg.slo)

        def deliver(f):
            if self._killed:
                return                  # a dead transport sends nothing
            now = time.monotonic()
            if now < self._slow_until and self._slow_factor > 1.0:
                time.sleep(min((self._slow_factor - 1.0) * (now - t0),
                               self._slow_until - now))
            cb = self._on_result
            if cb is not None:
                cb(self.name, _result_for(msg.req_id, f))

        fut.add_done_callback(deliver)
        return True

    # -- chaos hooks ----------------------------------------------------
    def kill(self) -> None:
        self._killed = True

    def restart(self) -> None:
        self._killed = False

    def slow(self, factor: float, duration_s: float) -> None:
        self._slow_factor = max(float(factor), 1.0)
        self._slow_until = time.monotonic() + max(duration_s, 0.0)

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout)
            self._hb_thread = None
        if self._sched is not None:
            self._sched.shutdown(timeout=timeout)


# ---------------------------------------------------------------------------
# subprocess worker (pipe tomorrow — which is today now)
# ---------------------------------------------------------------------------
class ProcWorker:
    """A fleet worker hosted in a child process.

    The child runs ``python -m repro_torch.serve.worker --worker``
    with a dedicated pipe pair passed by fd; ``env`` overrides (on top
    of the parent's environment) point it at the shared
    calibration/tune stores.  ``device`` is passed on as the child's
    ``--device``: ``None`` builds the GPU + CPU pair (a child with no
    GPU then fails at start, and the router sees a dead worker),
    ``"cpu"`` the simulated pair on the CPU.  The child is started with
    ``subprocess.Popen`` (fork then exec), which is safe after this
    process has initialised CUDA.  ``kill()`` is a real SIGKILL;
    ``stall()``/``resume()`` are SIGSTOP/SIGCONT; ``restart`` spawns a
    fresh child under the same name (the cold rejoin path — its first
    placements come off the shared store).

    A child takes seconds to serve (its imports, a CUDA context, the
    scheduler's span probe); ``wait_ready`` waits for its first
    heartbeat, which it sends once its scheduler is built.  The router
    calls it at ``start()``, so a worker's heartbeat clock starts when
    it has announced itself, not when it was spawned."""

    def __init__(self, name: str, env: Optional[Dict[str, str]] = None,
                 hb_interval_s: Optional[float] = None, device=None):
        self.name = name
        self.env = dict(env or {})
        self.device = None if device is None else str(device)
        self._ready = threading.Event()
        self.hb_interval_s = (hb_interval_s if hb_interval_s is not None
                              else _env_float("REPRO_FLEET_HB_S", 1.0))
        self._proc: Optional[subprocess.Popen] = None
        self._wfile = None
        self._rfile = None
        self._wlock = threading.Lock()
        self._reader: Optional[threading.Thread] = None
        self._on_result = None
        self._on_heartbeat = None

    def start(self, on_result, on_heartbeat) -> None:
        self._on_result = on_result
        self._on_heartbeat = on_heartbeat
        if self._proc is None:
            self._spawn()

    def _spawn(self) -> None:
        self._ready = threading.Event()
        r_child, w_parent = os.pipe()          # parent -> child
        r_parent, w_child = os.pipe()          # child -> parent
        env = dict(os.environ)
        env.update(self.env)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else src)
        cmd = [sys.executable, "-m", "repro_torch.serve.worker",
               "--worker", "--name", self.name, "--in-fd", str(r_child),
               "--out-fd", str(w_child), "--hb", str(self.hb_interval_s)]
        if self.device is not None:
            cmd += ["--device", self.device]
        # stdout -> devnull: the frame protocol owns its own fds, and
        # library/adapter prints must go somewhere harmless; stderr inherits
        # so a crashing child leaves a traceback in the parent's log
        self._proc = subprocess.Popen(cmd, pass_fds=(r_child, w_child),
                                      env=env,
                                      stdout=subprocess.DEVNULL)
        os.close(r_child)
        os.close(w_child)
        self._wfile = os.fdopen(w_parent, "wb", buffering=0)
        self._rfile = os.fdopen(r_parent, "rb")
        self._reader = threading.Thread(
            target=self._read_loop, args=(self._rfile, self._ready),
            name=f"serve-fleet-rx-{self.name}", daemon=True)
        self._reader.start()

    def _read_loop(self, rfile, ready: threading.Event) -> None:
        while True:
            try:
                msg = _recv_frame(rfile)
            except (EOFError, OSError, pickle.UnpicklingError):
                return
            try:
                if isinstance(msg, ResultMsg):
                    cb = self._on_result
                    if cb is not None:
                        cb(self.name, msg)
                elif isinstance(msg, HeartbeatMsg):
                    ready.set()
                    cb = self._on_heartbeat
                    if cb is not None:
                        cb(self.name, msg)
            except Exception:                  # noqa: BLE001
                pass                   # a callback bug must not kill rx

    @property
    def transport_alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        """The current child's process id (None before the first
        start)."""
        return None if self._proc is None else self._proc.pid

    def wait_ready(self, timeout: float = 600.0) -> bool:
        """Wait for the child's first heartbeat; False when the child
        exited first or the wait timed out."""
        deadline = time.monotonic() + timeout
        while not self._ready.wait(0.05):
            if not self.transport_alive or time.monotonic() > deadline:
                return False
        return True

    def _send(self, msg) -> bool:
        if not self.transport_alive or self._wfile is None:
            return False
        try:
            with self._wlock:
                _send_frame(self._wfile, msg)
            return True
        except (OSError, ValueError):
            return False

    def submit(self, msg: SubmitMsg) -> bool:
        return self._send(msg)

    def ping(self) -> None:
        self._send(PingMsg())

    # -- chaos hooks ----------------------------------------------------
    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()                  # SIGKILL: no goodbye

    def stall(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            os.kill(self._proc.pid, 19)        # SIGSTOP

    def resume(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            os.kill(self._proc.pid, 18)        # SIGCONT

    def slow(self, factor: float, duration_s: float) -> None:
        self._send(SlowMsg(factor=factor, duration_s=duration_s))

    def restart(self) -> None:
        self._close(kill=True)
        self._spawn()

    def _close(self, kill: bool = False, timeout: float = 10.0) -> None:
        proc = self._proc
        if proc is not None:
            if kill and proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout)
        for f in (self._wfile, self._rfile):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        self._wfile = self._rfile = None
        reader = self._reader
        if reader is not None:
            reader.join(timeout)
            self._reader = None
        self._proc = None

    def shutdown(self, timeout: float = 30.0) -> None:
        if self._proc is None:
            return
        self._send(ShutdownMsg())
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            pass
        self._close(kill=True, timeout=timeout)


# ---------------------------------------------------------------------------
# child entry point
# ---------------------------------------------------------------------------
def _cuda_memory_reserved() -> float:
    """Bytes this process's caching allocator holds on its GPUs (0 before
    it touched one).  A worker reports its own: ``nvidia-smi`` cannot
    tell a container's processes apart by pid."""
    import torch
    if not torch.cuda.is_initialized():
        return 0.0
    return float(sum(torch.cuda.memory_reserved(i)
                     for i in range(torch.cuda.device_count())))


def worker_main(argv=None) -> int:
    """Host one Scheduler behind a pipe transport (see module doc)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--name", default="worker")
    ap.add_argument("--in-fd", type=int, required=True)
    ap.add_argument("--out-fd", type=int, required=True)
    ap.add_argument("--hb", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="the scheduler's accel device (default: the "
                         "first GPU; 'cpu' simulates the pair)")
    args = ap.parse_args(argv)

    rfile = os.fdopen(args.in_fd, "rb")
    wfile = os.fdopen(args.out_fd, "wb", buffering=0)
    wlock = threading.Lock()

    from repro_torch.kernels import common
    from repro_torch.obs import get_recorder
    from repro_torch.serve.scheduler import Scheduler

    sched = Scheduler(device=args.device)
    # the store this scheduler's executor reads and writes (its section
    # is keyed by the backend: torch:cuda or torch:cpu)
    calib = sched._ex.cache
    rec = get_recorder()
    stop = threading.Event()
    slow = {"factor": 1.0, "until": 0.0}

    def send(msg) -> None:
        try:
            with wlock:
                _send_frame(wfile, msg)
        except (OSError, ValueError):
            stop.set()                 # parent gone: time to exit

    def beat() -> None:
        st = sched.stats
        stats = st.snapshot()
        stats["cuda_memory_reserved"] = _cuda_memory_reserved()
        # the child's kernel launches (by kernel, by C entry): a parent's
        # launch counts cannot see another process's
        stats.update({f"launches.{k}": float(v)
                      for k, v in common.launch_counts().items()})
        stats.update({f"entry_launches.{k}": float(v)
                      for k, v in common.entry_counts().items()})
        # drained events ride the heartbeat: a SIGKILLed worker loses at
        # most one beat interval of spans, a clean shutdown loses none
        # (the final beat below ships the tail)
        send(HeartbeatMsg(time.monotonic(), load=float(st.in_flight),
                          stats=stats, spans=tuple(rec.drain())))
        # keep the shared merge-on-write store fresh for peers and for
        # cold workers joining the fleet (zero-probe contract)
        calib.flush()

    def hb_loop() -> None:
        while not stop.wait(max(args.hb, 0.05)):
            beat()

    hb = threading.Thread(target=hb_loop, name="serve-fleet-hb",
                          daemon=True)
    hb.start()
    beat()                             # announce liveness immediately

    def handle_submit(msg: SubmitMsg) -> None:
        t0 = time.monotonic()
        fut = sched.submit(msg.workload, msg.payload,
                           deadline=msg.deadline_s,
                           priority=msg.priority, hedge=msg.hedge,
                           trace_id=msg.trace_id,
                           slo_class=msg.slo)

        def deliver(f):
            now = time.monotonic()
            if now < slow["until"] and slow["factor"] > 1.0:
                time.sleep(min((slow["factor"] - 1.0) * (now - t0),
                               slow["until"] - now))
            try:
                send(_result_for(msg.req_id, f))
            except pickle.PicklingError:
                send(ResultMsg(msg.req_id, ok=False,
                               error="result not picklable"))

        fut.add_done_callback(deliver)

    while not stop.is_set():
        try:
            msg = _recv_frame(rfile)
        except (EOFError, OSError):
            break
        if isinstance(msg, SubmitMsg):
            handle_submit(msg)
        elif isinstance(msg, PingMsg):
            beat()
        elif isinstance(msg, SlowMsg):
            slow["factor"] = max(float(msg.factor), 1.0)
            slow["until"] = time.monotonic() + max(msg.duration_s, 0.0)
        elif isinstance(msg, ShutdownMsg):
            break

    sched.drain(timeout=60)
    sched.shutdown()
    calib.flush()
    stop.set()
    hb.join(5.0)
    beat()                             # final flush: ship leftover spans
    return 0

