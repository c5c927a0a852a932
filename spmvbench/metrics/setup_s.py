"""Seconds from the process's start to the window's: imports, the
kernels' build where it is stale, the matrix made, ``prepare`` and the
warm-up solve."""


def read(ctx):
    return ctx.setup_s
