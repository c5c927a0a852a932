"""Work of the window's ``run`` calls over the window: 2 (nnz + rows) a
call (the repo's own count), every call and every second of the window."""


def read(ctx):
    if ctx.call != "run" or ctx.window_s <= 0:
        return None
    return 2.0 * (ctx.nnz + ctx.rows) * ctx.calls / ctx.window_s / 1e9
