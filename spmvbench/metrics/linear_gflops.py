"""Work of the window's ``linear`` calls over the window: 2 B (nnz + rows)
a call at a batch of B, every call and every second of the window."""


def read(ctx):
    if ctx.call != "linear" or ctx.window_s <= 0:
        return None
    return (2.0 * ctx.batch * (ctx.nnz + ctx.rows) * ctx.calls
            / ctx.window_s / 1e9)
