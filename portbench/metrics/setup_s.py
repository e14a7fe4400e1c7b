"""Seconds from the process's start to the window's: loading, drawing the
inputs, building the pipeline, the kernels' first build, the warm-up."""


def read(ctx):
    return ctx.setup_s
