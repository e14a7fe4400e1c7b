"""Device time launched from the training plane (call sites in
core/train_plane.py or optim/) over the device time of all call sites,
in %, over one launch profiled with stacks after the window."""


def read(ctx):
    s = ctx.train_sites
    if not s or not s[1]:
        return None
    return 100.0 * s[0] / s[1]
