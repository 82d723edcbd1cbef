"""The prefill's share of the card's bf16 peak, in percent: the FLOPs of
the prefills started in the window before the profiled stretch
(``harness.counts.prefill_flops``,
from the configuration file's widths) over their summed wrapped time
times the peak (``bench/peaks.json``, by the card's name)."""
from bench.harness.counts import prefill_flops


def read(ctx):
    if ctx.calls is None or not ctx.peaks:
        return None
    d = [t1 - t0 for t0, t1, _ in ctx.calls.prefills
         if ctx.t0 <= t0 < ctx.steady_end]
    if not d:
        return None
    flops = prefill_flops(ctx.conf, ctx.prompt_len) * len(d)
    return 100.0 * flops / (sum(d) * ctx.peaks["bf16_flops"])
