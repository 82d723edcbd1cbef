"""The device's idle share over the profiled stretch of a closed-loop
window (``harness.trace.idle_share``)."""
from bench.harness.trace import idle_share as read  # noqa: F401
