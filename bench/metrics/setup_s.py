"""Seconds from the process's start to the window's: imports, the
kernel build where it is not cached, the weights, the adapter, the
engine and the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
