"""The share of the traced window in which the device was idle while the
host was inside the program's ``run``: the device waits on the call's
host work (checks, dispatch, launches) (``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    if ctx.call != "run":
        return None
    return program.host_wait_share(program.record(), ctx.trace, "run")
