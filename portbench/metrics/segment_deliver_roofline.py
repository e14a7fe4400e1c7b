"""Kernel 1 (segment_deliver_kernel and its fixup, through
ops.deliver_rows): the least time its launches in the profiled window
could take, their bytes over 3.35 TB/s, over their measured device time,
in %."""
from portbench.yardstick.kernel_bytes import roofline_share


def read(ctx):
    return roofline_share(ctx, "deliver_rows")
