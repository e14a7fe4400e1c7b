"""Reads answered with an embedding (ok) over the reads due in the window,
in %."""


def read(ctx):
    c = ctx.counts
    if not c.get("queries_due"):
        return None
    return 100.0 * c["ok"] / c["queries_due"]
