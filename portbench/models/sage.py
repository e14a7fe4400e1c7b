"""GraphSAGE-mean on the D3-GNN engine: the layer stack the configuration's
sizes give, its weights drawn from the seed, and its dense FLOPs.

A model on the engine is a module here that the configuration names under
`model_module`, with the four functions below.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.traffic.generator import WEIGHTS, torch_seed


def dims(cfg: dict) -> list:
    """Each layer's input width, then the last layer's output width."""
    return [cfg["d_in"]] + [cfg["d_hid"]] * cfg["n_layers"]


def draw_weights(dims, n_classes, seed, device) -> dict:
    """Every weight in one draw on the device: w ~ N(0, 1 / fan_in),
    biases ~ N(0, 0.01^2); {l{i}: {self: {w, b}, neigh: {w}}, head}."""
    shapes = []
    for i in range(len(dims) - 1):
        shapes += [(f"l{i}", "self", "w", (dims[i], dims[i + 1])),
                   (f"l{i}", "self", "b", (dims[i + 1],)),
                   (f"l{i}", "neigh", "w", (dims[i], dims[i + 1]))]
    if n_classes:
        shapes += [("head", None, "w", (dims[-1], n_classes)),
                   ("head", None, "b", (n_classes,))]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed,
                                                                WEIGHTS))
    flat = torch.randn(sum(int(np.prod(s)) for *_, s in shapes),
                       generator=gen, device=device)
    out, at = {}, 0
    for top, sub, leaf, shape in shapes:
        n = int(np.prod(shape))
        x = flat[at:at + n].reshape(shape)
        at += n
        x = x * (0.01 if leaf == "b" else shape[0] ** -0.5)
        node = out.setdefault(top, {})
        (node.setdefault(sub, {}) if sub else node)[leaf] = x.contiguous()
    return out


def build(dims, n_classes, weights, device):
    """The program's layer stack (and head) holding `weights`."""
    from repro_torch.graph.sage import GraphSAGE, load_linear_tree
    model = GraphSAGE(dims, seed=0, n_classes=n_classes).to(device)
    for i, layer in enumerate(model.layers):
        layer.load_param_tree(weights[f"l{i}"])
    if n_classes:
        load_linear_tree(model.head, weights["head"])
    return model


def vertex_flops(d_in: int, d_out: int) -> int:
    """Dense FLOPs of one vertex update of a layer: W_self and W_neigh."""
    return 4 * d_in * d_out
