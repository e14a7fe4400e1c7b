"""The program's `dispatch` phase (the host enqueuing the T tick
programs, up to the launch's one read) over T, in ms a micro-tick; the
median over the newest pipeline's loaded, unprofiled launches."""
from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.median_of(
        lambda r: r["spans"]["dispatch"] * 1e3 / r["T"])
