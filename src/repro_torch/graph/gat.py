"""Graph Attention Network (arXiv:1710.10903) — one of the paper's
supported MPGNN instantiations (§3.3).

Counterpart of `repro/graph/gat.py`. Edge attention is a segment softmax
over in-edges, for each head (the heads' columns side by side: each is
normalised on its own, as the reference's per-head loop does).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph
from repro_torch.nn.initializers import lecun_normal
from repro_torch.nn.layers import Linear


class GATLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, n_heads: int = 4,
                 act: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if out_dim % n_heads:
            raise ValueError(f"out_dim {out_dim} is not a multiple of "
                             f"n_heads {n_heads}")
        self.out_dim, self.n_heads, self.act = out_dim, n_heads, act
        dh = out_dim // n_heads
        self.w = Linear(in_dim, out_dim, use_bias=False, generator=generator,
                        device=device)
        self.a_src = nn.Parameter(lecun_normal((n_heads, dh), generator,
                                               device))
        self.a_dst = nn.Parameter(lecun_normal((n_heads, dh), generator,
                                               device))

    def forward(self, g: Graph, x):
        N, H = g.n_nodes, self.n_heads
        h = self.w(x).reshape(N, H, self.out_dim // H)
        e_src = torch.einsum("nhd,hd->nh", h, self.a_src.to(h.dtype))
        e_dst = torch.einsum("nhd,hd->nh", h, self.a_dst.to(h.dtype))
        scores = F.leaky_relu(e_src[g.senders] + e_dst[g.receivers], 0.2)
        alpha = segment.segment_softmax(scores, g.receivers, N,
                                        g.edge_mask)             # [E, H]
        msgs = h[g.senders] * alpha[..., None]
        agg = segment.segment_sum(msgs, g.receivers, N, g.edge_mask)
        out = agg.reshape(N, self.out_dim)
        return F.elu(out) if self.act else out


class GAT(nn.Module):
    """GAT layers of widths `dims` and an optional Linear head; runs on
    `device` (CUDA unless given, raising without it), weights drawn from
    a generator seeded with `seed`."""

    def __init__(self, dims, n_heads: int = 4, n_classes: int = 0,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.dims, self.n_classes = tuple(dims), n_classes
        n = len(self.dims) - 1
        self.layers = nn.ModuleList(
            GATLayer(self.dims[i], self.dims[i + 1], n_heads,
                     act=i < n - 1 or n_classes > 0, generator=gen,
                     device=dev) for i in range(n))
        self.head = (Linear(self.dims[-1], n_classes, generator=gen,
                            device=dev) if n_classes else None)

    def forward(self, g: Graph, x=None):
        x = g.x if x is None else x
        for layer in self.layers:
            x = layer(g, x)
        return self.head(x) if self.head is not None else x
