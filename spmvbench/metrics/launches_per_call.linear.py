"""Kernel launches a ``linear`` call: the program's ``kernel.*`` spans (one
a call of a kernel wrapper) inside its ``linear`` calls of the traced
window over the number of those calls (``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    if ctx.call != "linear":
        return None
    return program.launches_per_call(program.record(), ctx.trace, "linear")
