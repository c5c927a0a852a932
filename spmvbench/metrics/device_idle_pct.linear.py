"""The share of the traced window in which no operation ran on the
device: 1 - (union of the device's operations) / the window."""


def read(ctx):
    if ctx.call != "linear" or ctx.trace is None:
        return None
    window, busy = ctx.trace.window_s, ctx.trace.busy_s
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
