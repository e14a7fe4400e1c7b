"""Kernel 2 (mean_rows_gather_kernel): the least time its launches in the
profiled window could take, their bytes over 3.35 TB/s, over their
measured device time, in %."""
from portbench.yardstick.kernel_bytes import roofline_share


def read(ctx):
    return roofline_share(ctx, "mean_rows_gather")
