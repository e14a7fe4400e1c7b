"""HDRF's host time an edge: the program's `stage.partition` span (the
partitioner's per-edge loop) over the launch's edges, in microseconds;
the median over the newest pipeline's loaded, unprofiled launches."""
from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.median_of(
        lambda r: r["spans"]["stage.partition"]
        / r["counts"]["edges"] * 1e6)
