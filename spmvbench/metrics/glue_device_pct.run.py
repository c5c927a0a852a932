"""The share of a ``run`` call's device time spent outside its kernels:
the device time of the operations that the program's ``run`` calls of
the traced window launched outside any ``kernel.*`` span (pad, permute,
transposes, residual, epilogue, fills outside a wrapper), over the device
time of all that they launched (``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    if ctx.call != "run":
        return None
    return program.glue_share(program.record(), ctx.trace, "run")
