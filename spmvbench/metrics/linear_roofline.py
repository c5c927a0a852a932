"""The share of its roofline that a ``linear`` call reaches: the least
time its inputs need (``roofline.least_seconds``) over the mean device
time of the operations each call of the traced window launched."""

from spmvbench.roofline import least_seconds


def read(ctx):
    if ctx.call != "linear" or ctx.trace is None or ctx.peaks is None:
        return None
    device_s, calls = ctx.trace.call_device_s("spmvbench.linear")
    if calls == 0 or device_s <= 0:
        return None
    least = least_seconds(ctx.peaks, ctx.rows, ctx.cols, ctx.nnz,
                          ctx.batch, ctx.y_in)
    return 100.0 * least / (device_s / calls)
