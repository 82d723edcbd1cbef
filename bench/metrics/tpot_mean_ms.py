"""Time per output token, the mean over the served requests sent in the
window: (last-token stamp - first-token stamp) / new tokens."""


def read(ctx):
    per = [(r.t_last - r.t_first) / ctx.new_tokens for r in ctx.records
           if r.ok and r.t_first is not None and r.t_last is not None]
    return 1e3 * sum(per) / len(per) if per else None
