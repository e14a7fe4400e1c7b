"""The program's host staging seconds (StreamMetrics.host_seconds, a host
clock around partitioning and batch building) over the window, in %."""


def read(ctx):
    c = ctx.counts
    return 100.0 * c["host_s"] / c["window_s"]
