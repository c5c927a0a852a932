"""Seconds of the program's host packing in ``prepare``: the own time of
its ``prepare.pack`` spans, their ``upload`` children left out, from the
program's own record (``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    return program.setup_seconds(program.record(), "prepare.pack", own=True)
