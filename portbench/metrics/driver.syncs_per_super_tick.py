"""Synchronizing CUDA calls the program made over the window (counted
under torch.cuda.set_sync_debug_mode("warn")), per launch."""


def read(ctx):
    if ctx.syncs is None:
        return None
    return ctx.syncs / ctx.counts["launches"]
