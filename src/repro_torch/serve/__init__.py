"""Serving: the request scheduler over the GPU + CPU pair, its queue,
placement policy and request adapters, and batched prefill + greedy
decode.  The continuous-batching engine is not ported yet (ROADMAP
queue 1, item 5)."""
from repro_torch.serve.placement import (DEDICATED, SHARED, GroupLoad,
                                         PlacementDecision,
                                         deadline_feasible,
                                         degraded_fraction, plan_placement)
from repro_torch.serve.request_queue import (Rejection, Request,
                                             RequestQueue, RequestRejected,
                                             ServeFuture)
from repro_torch.serve.scheduler import Scheduler, shutdown_all

__all__ = ["DEDICATED", "SHARED", "GroupLoad", "PlacementDecision",
           "deadline_feasible", "degraded_fraction", "plan_placement",
           "Rejection", "Request", "RequestQueue", "RequestRejected",
           "ServeFuture", "Scheduler", "shutdown_all"]
