"""The program's `upload` phase a launch (stacking, pinning and issuing
the host-to-device copies of the T ticks' batches), in ms; the median
over the newest pipeline's loaded, unprofiled launches."""
from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.median_of(lambda r: r["spans"]["upload"] * 1e3)
