"""Principal Neighbourhood Aggregation (PNA) — arXiv:2004.05718.

Counterpart of `repro/graph/pna.py`. Assigned config: n_layers=4,
d_hidden=75, aggregators mean/max/min/std, scalers identity /
amplification / attenuation. Message = MLP([x_u ; x_v]); the 4
aggregators x 3 scalers concat to 12·d, beside x, compressed by a linear.
All four aggregators are synopses (std via (Σm, Σm², n)).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph, in_degree
from repro_torch.graph.sage import masked_ce
from repro_torch.nn.layers import MLP, Linear


class PNALayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, avg_log_deg: float = 1.0,
                 act: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.avg_log_deg, self.act = avg_log_deg, act
        self.pre = MLP((2 * in_dim, in_dim), generator=generator,
                       device=device)
        self.post = Linear(12 * in_dim + in_dim, out_dim,
                           generator=generator, device=device)

    def forward(self, g: Graph, x):
        m = self.pre(torch.cat([x[g.senders], x[g.receivers]], dim=-1))
        N, r, mask = g.n_nodes, g.receivers, g.edge_mask
        aggs = torch.cat([
            segment.segment_mean(m, r, N, mask),
            segment.segment_max(m, r, N, mask),
            segment.segment_min(m, r, N, mask),
            segment.segment_std(m, r, N, mask),
        ], dim=-1)                                              # [N, 4d]
        logd = torch.log(in_degree(g) + 1.0)
        amp = (logd / self.avg_log_deg)[:, None]
        att = (self.avg_log_deg / torch.clamp(logd, min=1e-6))[:, None]
        scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)  # [N, 12d]
        h = self.post(torch.cat([x, scaled], dim=-1))
        return torch.relu(h) if self.act else h


class PNA(nn.Module):
    """PNA layers (each with its relu) and an optional Linear head; runs
    on `device` (CUDA unless given, raising without it)."""

    def __init__(self, d_in: int, d_hidden: int = 75, n_layers: int = 4,
                 n_classes: int = 0, avg_log_deg: float = 1.0, seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.d_in, self.n_classes = d_in, n_classes
        self.d_hidden, self.n_layers = d_hidden, n_layers
        dims = [d_in] + [d_hidden] * n_layers
        self.layers = nn.ModuleList(
            PNALayer(dims[i], dims[i + 1], avg_log_deg, generator=gen,
                     device=dev) for i in range(n_layers))
        self.head = (Linear(d_hidden, n_classes, generator=gen, device=dev)
                     if n_classes else None)

    def forward(self, g: Graph, x=None):
        x = g.x if x is None else x
        for layer in self.layers:
            x = layer(g, x)
        return self.head(x) if self.head is not None else x

    def loss(self, g: Graph, labels, label_mask):
        """Masked-mean cross-entropy of the head's logits (JAX's
        `loss`)."""
        return masked_ce(self(g), labels, label_mask)
