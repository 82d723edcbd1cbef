"""Serving: the request scheduler over the GPU + CPU pair, its queue,
placement policy and request adapters, batched prefill + greedy
decode, the continuous-batching engine, the fleet tier (a
consistent-hash router over in-process or child-process scheduler
workers, ``router`` and ``transport``) and the replayable traffic
scenarios (``scenario``)."""
from repro_torch.serve.placement import (DEDICATED, SHARED, GroupLoad,
                                         PlacementDecision,
                                         deadline_feasible,
                                         degraded_fraction, plan_placement)
from repro_torch.serve.request_queue import (Rejection, Request,
                                             RequestQueue, RequestRejected,
                                             ServeFuture)
from repro_torch.serve.router import HashRing, Router, default_bucket
from repro_torch.serve.scenario import (Phase, ScenarioSpec, TraceEvent,
                                        build_trace, load_spec,
                                        run_scenario, trace_digest)
from repro_torch.serve.scheduler import Scheduler, shutdown_all
from repro_torch.serve.transport import (HeartbeatMsg, InProcWorker,
                                         ProcWorker, ResultMsg, SubmitMsg)

__all__ = ["DEDICATED", "SHARED", "GroupLoad", "PlacementDecision",
           "deadline_feasible", "degraded_fraction", "plan_placement",
           "Rejection", "Request", "RequestQueue", "RequestRejected",
           "ServeFuture", "Scheduler", "shutdown_all", "HashRing",
           "Router", "default_bucket", "Phase", "ScenarioSpec",
           "TraceEvent", "build_trace", "load_spec", "run_scenario",
           "trace_digest", "HeartbeatMsg", "InProcWorker", "ProcWorker",
           "ResultMsg", "SubmitMsg"]
