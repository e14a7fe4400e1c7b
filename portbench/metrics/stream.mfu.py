"""The model's dense FLOPs over the window against the float32 peak
(67 TFLOP/s; the configuration computes in float32 with TF32 off), in %.

Counted: 4 d_in d_out a vertex update (W_self and W_neigh) for every
update a layer emitted; with training, 3x the forward FLOPs of every
layer and the head (4 d_in d_out, 2 d_out classes) over batch_threshold
rows a fired step, the least batch a step fires on."""
from portbench.yardstick import peaks


def read(ctx):
    c, cfg = ctx.counts, ctx.cfg
    dims = [cfg["d_in"]] + [cfg["d_hid"]] * cfg["n_layers"]
    flops = sum(4 * a * b * n for a, b, n in zip(dims, dims[1:],
                                                 c["emitted"]))
    t = cfg.get("train")
    if t:
        fwd = sum(4 * a * b for a, b in zip(dims, dims[1:])) \
            + 2 * dims[-1] * t["n_classes"]
        flops += c["fired"] * t["batch_threshold"] * 3 * fwd
    return 100.0 * flops / c["window_s"] / peaks.F32_FLOPS_PER_S
