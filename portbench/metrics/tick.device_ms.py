"""Device busy milliseconds per micro-tick over the profiled launches."""


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"]:
        return None
    return t["busy_s"] * 1e3 / (t["launches"] * ctx.mix["super_ticks"])
