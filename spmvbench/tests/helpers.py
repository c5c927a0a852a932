"""A cell of ``BENCHMARK.json`` at a size a test run can hold."""

from spmvbench import manifest


def _hex(grid, nnz):
    rows = 3 * grid[0] * grid[1] * grid[2]
    return {"rows": rows, "cols": rows, "nnz": nnz,
            "params": {"grid": grid, "periodic": [True, False, False],
                       "dof": 3}}


def _square(rows, nnz):
    return {"rows": rows, "cols": rows, "nnz": nnz}


# what a configuration's file is cut to in the tests: for flan1565 a
# shorter and narrower ring, for pokec fewer rows at its nonzeros a row
SMALL = {"flan1565": _hex([8, 12, 7], 2016 * 66),
         "pokec": _square(4096, 4096 * 19)}
# flan1565's cross-section whole, 100 nodes around, at its nonzeros a row
MEDIUM = {"flan1565": _hex([100, 42, 11], 10_112_080),
          "pokec": _square(100_000, 1_900_000)}


def cell_spec(cell, sizes=SMALL, iterations=None):
    """``cell`` cut to ``sizes``, and to ``iterations`` calls a solve where
    given."""
    spec = manifest.cell_spec(manifest.load(), cell)
    cut = sizes[spec["config"]["name"]]
    params = dict(spec["config"].get("params", {}), **cut.get("params", {}))
    spec["config"] = dict(spec["config"], **dict(cut, params=params))
    if iterations:
        spec["traffic"] = dict(spec["traffic"], iterations=iterations)
    return spec


CELLS = [w["name"] for w in manifest.load()["workloads"]]
