"""Seconds of the program's planning in ``prepare``: its ``prepare.plan``
spans (the planner: the block packer's plan, the routed planner's
estimate, builds and repack), from the program's own record
(``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    return program.setup_seconds(program.record(), "prepare.plan")
