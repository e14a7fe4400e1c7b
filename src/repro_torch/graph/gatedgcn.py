"""GatedGCN — arXiv:1711.07553 / benchmarking-gnns (arXiv:2003.00982).

Counterpart of `repro/graph/gatedgcn.py`. Assigned config: n_layers=16,
d_hidden=70, gated aggregator:

    e_ij' = e_ij + ReLU(Norm(A x_i + B x_j + C e_ij))
    eta   = sigma(e_ij') / (sum_j sigma(e_ij') + eps)
    x_i'  = x_i + ReLU(Norm(U x_i + sum_j eta_ij * (V x_j)))

with LayerNorm, as the reference (batch statistics are ill-defined in the
streaming engine's micro-ticks).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph
from repro_torch.graph.sage import masked_ce
from repro_torch.nn.layers import LayerNorm, Linear


class GatedGCNLayer(nn.Module):
    def __init__(self, dim: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        for name in ("A", "B", "C", "U", "V"):
            setattr(self, name, Linear(dim, dim, generator=generator,
                                       device=device))
        self.norm_e = LayerNorm(dim, device=device)
        self.norm_x = LayerNorm(dim, device=device)

    def forward(self, g: Graph, x, e):
        """x: [N, d], e: [E, d] -> (x', e')."""
        xi, xj = x[g.receivers], x[g.senders]
        e_hat = self.A(xi) + self.B(xj) + self.C(e)
        e_new = e + torch.relu(self.norm_e(e_hat))
        gate = torch.sigmoid(e_new)
        vj = self.V(xj) * gate
        num = segment.segment_sum(vj, g.receivers, g.n_nodes, g.edge_mask)
        den = segment.segment_sum(gate, g.receivers, g.n_nodes, g.edge_mask)
        h = self.U(x) + num / (den + 1e-6)
        x_new = x + torch.relu(self.norm_x(h))
        return x_new, e_new


class GatedGCN(nn.Module):
    """Embeddings of x and of the edge input (ones when the graph has no
    edge_attr), `n_layers` gated layers and an optional Linear head; runs
    on `device` (CUDA unless given, raising without it)."""

    def __init__(self, d_in: int, d_hidden: int = 70, n_layers: int = 16,
                 n_classes: int = 0, d_edge_in: int = 0, seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.d_in, self.n_classes = d_in, n_classes
        self.d_hidden, self.n_layers = d_hidden, n_layers
        self.embed_x = Linear(d_in, d_hidden, generator=gen, device=dev)
        self.embed_e = Linear(max(d_edge_in, 1), d_hidden, generator=gen,
                              device=dev)
        self.layers = nn.ModuleList(GatedGCNLayer(d_hidden, gen, dev)
                                    for _ in range(n_layers))
        self.head = (Linear(d_hidden, n_classes, generator=gen, device=dev)
                     if n_classes else None)

    def forward(self, g: Graph, x=None):
        x = self.embed_x(g.x if x is None else x)
        e_in = g.edge_attr if g.edge_attr is not None else torch.ones(
            (g.n_edges, 1), dtype=x.dtype, device=x.device)
        e = self.embed_e(e_in)
        for layer in self.layers:
            x, e = layer(g, x, e)
        return self.head(x) if self.head is not None else x

    def loss(self, g: Graph, labels, label_mask):
        """Masked-mean cross-entropy of the head's logits (JAX's
        `loss`)."""
        return masked_ce(self(g), labels, label_mask)
