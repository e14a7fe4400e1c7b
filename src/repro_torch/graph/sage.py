"""GraphSAGE — the paper's evaluation model (2-layer SAGE-mean, dim 64).

Counterpart of `repro/graph/sage.py` (SAGE layers only):

    x_v' = act( W_self x_v + W_neigh mean_{u in N_in(v)} x_u )

`message` (phi) and `update` (psi) are what the streaming tick calls;
`forward` is the static full-graph layer the oracle runs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph
from repro_torch.nn.layers import Linear


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

    def forward(self, g: Graph, x):
        agg = segment.segment_mean(x[g.senders], g.receivers, g.n_nodes,
                                   g.edge_mask)
        return self.update(x, agg)


class GraphSAGE(nn.Module):
    """Stack of SAGE layers; the paper's model is dims=(in, 64, 64).
    Weights are drawn from a `torch.Generator` seeded with `seed`."""

    def __init__(self, dims: Sequence[int], seed: int = 0):
        super().__init__()
        self.dims = tuple(dims)
        gen = torch.Generator().manual_seed(seed)
        n = len(self.dims) - 1
        self.layers = nn.ModuleList(
            SAGELayer(self.dims[i], self.dims[i + 1], act=i < n - 1,
                      generator=gen)
            for i in range(n))

    def forward(self, g: Graph, x=None):
        x = g.x if x is None else x
        for layer in self.layers:
            x = layer(g, x)
        return x
