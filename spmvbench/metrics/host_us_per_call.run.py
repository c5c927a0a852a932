"""Host microseconds inside the program's ``run`` a call: the
benchmark's own spans around each call of the measured window (outside
the profiler's window)."""


def read(ctx):
    if ctx.call != "run" or not ctx.host_calls:
        return None
    return ctx.host_call_s / ctx.host_calls * 1e6
