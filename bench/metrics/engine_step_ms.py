"""The mean of the program's ``engine_step`` spans recorded in the
window before the profiled stretch (``serve/continuous.py``; each includes its wait for the lane
lock)."""


def read(ctx):
    durs = [e["dur"] for e in ctx.spans or () if e.get("name") == "engine_step"
            and e.get("ph") == "X"]
    return sum(durs) / len(durs) / 1e3 if durs else None
