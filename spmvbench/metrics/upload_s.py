"""Seconds of the program's uploads to the device: every ``upload`` span
of ``prepare`` and after it (where a layout uploads its arrays at first
use, as the block format does B6's, in the warm-up), from the program's
own record (``spmvbench/program.py``)."""

from spmvbench import program


def read(ctx):
    return program.setup_seconds(program.record(), "upload")
