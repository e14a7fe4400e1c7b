"""Stream records (edges; labels too where the mix sends them) of every
launch of the window, over the window's seconds: from its start to the
return of its last launch."""


def read(ctx):
    c = ctx.counts
    return c["events"] / c["window_s"]
