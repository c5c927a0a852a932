"""Kernel launches a ``run`` call: the program's ``kernel.*`` spans (one
a call of a kernel wrapper) inside its ``run`` calls of the traced
window over the number of those calls (``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    if ctx.call != "run":
        return None
    return program.launches_per_call(program.record(), ctx.trace, "run")
