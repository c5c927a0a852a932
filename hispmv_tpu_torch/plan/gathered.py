"""The part of the gathered-stream planner that the routed planner reads.

Port of the constants and the cost model of ``hispmv_tpu/plan/gathered.py``
(TPU-measured, kept unchanged so that the routed planner's diversion gate
decides as the JAX package's does).  The gathered executor itself (its
planner and kernels B12/B13) is not ported yet (ROADMAP queue A, item 9):
:func:`build_gathered_plan` raises, so a routed plan that the JAX package
would give a gathered side-plan fails loudly instead of dropping the
diverted nonzeros.  The gate rejects diversion on every suite fixture
(``GATHERED.md``).
"""

from __future__ import annotations

FANOUT_CAP = 1016  # per-(panel, x-window) edge cap (slack under 1024)

# measured on the TPU (v5e), loop-slope over K in {64, 256, 512}
GATH_TILE_NS = 44.0  # kernel per tile (products+prefix+2xClos+RMW)
GATH_STAGE_NS = 20.0  # per gather-stage window incl. transpose share
GATH_LAUNCH_NS = 23e3  # launches + glue (measured intercept)


def gathered_cost_ns(num_tiles: int, num_windows: int = 0,
                     num_panels: int = 0) -> float:
    """Modeled device cost of executing a gathered plan."""
    if num_tiles == 0:
        return 0.0
    if not num_panels:
        num_panels = 1
    nwin_stages = 2 * num_panels * max(num_windows, 1) + num_tiles
    return GATH_LAUNCH_NS + num_tiles * GATH_TILE_NS \
        + nwin_stages * GATH_STAGE_NS


def build_gathered_plan(rows, cols, vals, shape, num_windows):
    """Not ported: the gathered executor (kernels B12 and B13) is ROADMAP
    queue A item 9.  Raises for the ``len(rows)`` nonzeros that the routed
    planner's gate would divert to it."""
    raise NotImplementedError(
        f"the routed planner would divert {len(rows)} nonzeros of a "
        f"{shape[0]}x{shape[1]} matrix to the gathered executor, which is "
        "not ported yet (kernels B12/B13, ROADMAP.md queue A item 9)"
    )
