"""The mean time of a wrapped ``LMStepper.prefill`` started in the window
before the profiled stretch (one prompt's prefill, its first token
read back to the host)."""


def read(ctx):
    d = [t1 - t0 for t0, t1, _ in (ctx.calls.prefills if ctx.calls else ())
         if ctx.t0 <= t0 < ctx.steady_end]
    return 1e3 * sum(d) / len(d) if d else None
