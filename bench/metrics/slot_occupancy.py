"""The mean share of the engine's slots live in a step: ``n_live`` /
slots over the program's ``engine_step`` spans in the window before
the profiled stretch."""


def read(ctx):
    live = [e["args"]["n_live"] for e in ctx.spans or ()
            if e.get("name") == "engine_step" and "n_live" in e.get("args", {})]
    return sum(live) / len(live) / ctx.n_slots if live else None
