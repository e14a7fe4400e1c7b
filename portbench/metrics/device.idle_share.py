"""One minus the union of kernels, copies and fills over the profiled
window, in %."""


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
