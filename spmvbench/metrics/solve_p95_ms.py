"""The 95th percentile of every solve of the window, each timed from its
first enqueue to its synchronise (host clock)."""

import numpy as np


def read(ctx):
    if not ctx.solve_s:
        return None
    return float(np.percentile(np.asarray(ctx.solve_s), 95)) * 1e3
