"""GraphSAGE and GCN — the paper's evaluation models (2-layer SAGE-mean,
dim 64).

Counterpart of `repro/graph/sage.py` (SAGE and GCN layers, the
classification head and its loss):

    SAGE:  x_v' = act( W_self x_v + W_neigh mean_{u in N_in(v)} x_u )
    GCN:   x_v' = act( W (x_v / d_v + sum_u x_u / sqrt(d_u d_v)) ),
           d = in-degree + 1 (the self loop)

`message` (phi) and `update` (psi) are what the streaming tick calls;
`forward` is the static full-graph model the oracle runs. The training
plane differentiates the layer through its functional forms
(`message_params`, `update_params`) over a parameter tree in the JAX
package's layout ({"self": {"w", "b"}, "neigh": {"w"}}; the head
{"w", "b"}), read with `param_tree` and written back with
`load_param_tree`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph, in_degree
from repro_torch.nn.layers import Linear


def linear_tree(lin: Linear) -> dict:
    """A Linear's parameters as a {"w"[, "b"]} tree (detached views)."""
    out = {"w": lin.w.detach()}
    if lin.b is not None:
        out["b"] = lin.b.detach()
    return out


def load_linear_tree(lin: Linear, tree: dict) -> None:
    """Copy a {"w"[, "b"]} tree into a Linear's parameters in place."""
    with torch.no_grad():
        for name, val in tree.items():
            getattr(lin, name).copy_(val)


def masked_ce(logits, labels, label_mask):
    """Masked-mean cross-entropy of [N, C] logits (f32) at int labels."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    gold = torch.take_along_dim(logp, labels[:, None], dim=-1)[:, 0]
    ce = torch.where(label_mask, -gold, 0.0)
    return torch.sum(ce) / torch.clamp(torch.sum(label_mask), min=1)


def output_loss(out, targets, n_classes: int):
    """The graph zoo's loss on a model's output (JAX's DimeNet / NequIP
    `loss`): with classes, targets = (labels, label_mask) and the
    masked-mean cross-entropy; else the mean squared error of the f32
    energies against targets."""
    if n_classes:
        labels, mask = targets
        return masked_ce(out, labels, mask)
    return torch.mean(torch.square(out.to(torch.float32) - targets))


class SAGELayer(nn.Module):
    agg_kind = "mean"   # aggregator synopsis kind (property of the type)

    def __init__(self, in_dim: int, out_dim: int, act: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.out_dim, self.act = in_dim, out_dim, act
        self.w_self = Linear(in_dim, out_dim, generator=generator)
        self.w_neigh = Linear(in_dim, out_dim, use_bias=False,
                              generator=generator)

    def message(self, x_u):
        """phi: identity on source features (SAGE-mean)."""
        return x_u

    def update(self, x_v, agg):
        """psi: W_self x_v + W_neigh agg (then relu if not final)."""
        h = self.w_self(x_v) + self.w_neigh(agg)
        return torch.relu(h) if self.act else h

    def linear_params(self, params, x_v, agg):
        """psi before its activation, over a parameter tree (the 2-D
        pipeline's StagedActLayer applies the relu as data)."""
        return (functional_call(self.w_self, params["self"], (x_v,))
                + functional_call(self.w_neigh, params["neigh"], (agg,)))

    def param_tree(self) -> dict:
        return {"self": linear_tree(self.w_self),
                "neigh": linear_tree(self.w_neigh)}

    def load_param_tree(self, tree: dict) -> None:
        load_linear_tree(self.w_self, tree["self"])
        load_linear_tree(self.w_neigh, tree["neigh"])

    def message_params(self, params, x_u):
        """phi over a parameter tree (SAGE: the identity)."""
        del params
        return x_u

    def update_params(self, params, x_v, agg):
        """psi over a parameter tree: the same arithmetic as `update`."""
        h = self.linear_params(params, x_v, agg)
        return torch.relu(h) if self.act else h

    def forward(self, g: Graph, x):
        agg = segment.segment_mean(x[g.senders], g.receivers, g.n_nodes,
                                   g.edge_mask)
        return self.update(x, agg)


class GraphSAGE(nn.Module):
    """Stack of SAGE layers; the paper's model is dims=(in, 64, 64).
    n_classes > 0 adds a Linear head (and the last layer keeps its relu,
    as in JAX). Weights are drawn from a `torch.Generator` seeded with
    `seed`, the layers first, then the head."""

    def __init__(self, dims: Sequence[int], seed: int = 0,
                 n_classes: int = 0):
        super().__init__()
        self.dims = tuple(dims)
        self.n_classes = n_classes
        gen = torch.Generator().manual_seed(seed)
        n = len(self.dims) - 1
        self.layers = nn.ModuleList(
            SAGELayer(self.dims[i], self.dims[i + 1],
                      act=i < n - 1 or n_classes > 0, generator=gen)
            for i in range(n))
        self.head = (Linear(self.dims[-1], n_classes, generator=gen)
                     if n_classes else None)

    def forward(self, g: Graph, x=None):
        x = g.x if x is None else x
        for layer in self.layers:
            x = layer(g, x)
        return self.head(x) if self.head is not None else x

    def loss(self, g: Graph, labels, label_mask):
        """Masked-mean cross-entropy of the head's logits."""
        return masked_ce(self(g), labels, label_mask)


class GCNLayer(nn.Module):
    agg_kind = "sum"     # deg-normalized sum synopsis (see SAGELayer)

    def __init__(self, in_dim: int, out_dim: int, act: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.act = act
        self.w = Linear(in_dim, out_dim, generator=generator, device=device)

    def forward(self, g: Graph, x):
        norm = torch.rsqrt(in_degree(g) + 1.0)[:, None]
        msg = (x * norm)[g.senders]
        agg = segment.segment_sum(msg, g.receivers, g.n_nodes, g.edge_mask)
        h = self.w((agg + x * norm) * norm)
        return torch.relu(h) if self.act else h


class GCN(nn.Module):
    """A stack of GCN layers with an optional Linear head, laid out as
    GAT is (`layers.<i>`, `head`; JAX: "l<i>", "head"). The JAX package
    has the layer only; this model composes it the way its GAT composes
    GATLayer, so the zoo's tests and train steps can run it. Runs on
    `device` (CUDA unless given, raising without it)."""

    def __init__(self, dims: Sequence[int], n_classes: int = 0,
                 seed: int = 0, device=None):
        super().__init__()
        from repro_torch.device import resolve_device, seeded_generator
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.dims, self.n_classes = tuple(dims), n_classes
        n = len(self.dims) - 1
        self.layers = nn.ModuleList(
            GCNLayer(self.dims[i], self.dims[i + 1],
                     act=i < n - 1 or n_classes > 0, generator=gen,
                     device=dev) for i in range(n))
        self.head = (Linear(self.dims[-1], n_classes, generator=gen,
                            device=dev) if n_classes else None)

    def forward(self, g: Graph, x=None):
        x = g.x if x is None else x
        for layer in self.layers:
            x = layer(g, x)
        return self.head(x) if self.head is not None else x
