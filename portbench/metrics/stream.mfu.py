"""The model's dense FLOPs over the window against the float32 peak
(67 TFLOP/s; the configuration computes in float32 with TF32 off), in %.

Counted: the model module's FLOPs of one vertex update a layer
(`vertex_flops`; GraphSAGE: 4 d_in d_out, W_self and W_neigh) for every
update a layer emitted; with training, 3x the forward FLOPs of every
layer and the head (2 d_out classes) over batch_threshold rows a fired
step, the least batch a step fires on."""
from portbench import models
from portbench.yardstick import peaks


def read(ctx):
    c, cfg = ctx.counts, ctx.cfg
    model = models.load(cfg["model_module"])
    dims = model.dims(cfg)
    layers = list(zip(dims, dims[1:]))
    flops = sum(model.vertex_flops(a, b) * n
                for (a, b), n in zip(layers, c["emitted"]))
    t = cfg.get("train")
    if t:
        fwd = sum(model.vertex_flops(a, b) for a, b in layers) \
            + 2 * dims[-1] * t["n_classes"]
        flops += c["fired"] * t["batch_threshold"] * 3 * fwd
    return 100.0 * flops / c["window_s"] / peaks.F32_FLOPS_PER_S
