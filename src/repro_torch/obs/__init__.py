"""Observability: the span recorder the hybrid executor traces into.

Dependency-free within the package — ``core`` imports it, never the
other way round.
"""
from repro_torch.obs.tracer import (TraceRecorder, get_recorder,
                                    new_trace_id, trace_enabled)

__all__ = ["TraceRecorder", "get_recorder", "new_trace_id",
           "trace_enabled"]
