"""Seconds of ``prepare`` (planning, packing, upload) on the host clock,
the device synchronised after it."""


def read(ctx):
    return ctx.prepare_s
