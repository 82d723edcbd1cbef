"""Observability: request tracing, lane timelines, placement audit.

Dependency-free within the package — ``core``/``serve`` import it,
never the other way round.
"""
from repro_torch.obs.tracer import (TraceRecorder, get_recorder,
                                    new_trace_id, trace_enabled)
from repro_torch.obs.audit import PlacementAudit

__all__ = ["TraceRecorder", "get_recorder", "new_trace_id",
           "trace_enabled", "PlacementAudit"]
