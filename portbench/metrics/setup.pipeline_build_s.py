"""Seconds the newest `D3Pipeline` took to build (the program's
`pipeline.build` record): host tables, the device state's allocation."""
from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.build_seconds()
