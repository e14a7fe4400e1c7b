"""Graph container (struct of tensors) and the power-law edge stream.

Counterpart of `repro/graph/graphs.py`, reduced to what the streaming
slice and its static oracle use. Directed edges run sender -> receiver;
messages aggregate at receivers (the paper's N_in(v) convention).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class Graph:
    senders: torch.Tensor                      # [E] int64
    receivers: torch.Tensor                    # [E] int64
    x: torch.Tensor                            # [N, d] node features
    edge_mask: Optional[torch.Tensor] = None   # [E] bool (None = all valid)
    node_mask: Optional[torch.Tensor] = None   # [N] bool

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]


def in_degree(g: Graph) -> torch.Tensor:
    ones = torch.ones(g.n_edges, dtype=torch.float32, device=g.x.device)
    if g.edge_mask is not None:
        ones = torch.where(g.edge_mask, ones, 0.0)
    return torch.zeros(g.n_nodes, dtype=torch.float32,
                       device=g.x.device).index_add_(0, g.receivers, ones)


def powerlaw_edges(rng: np.random.Generator, n_nodes: int, n_edges: int,
                   alpha: float = 1.5) -> np.ndarray:
    """Preferential-attachment-flavoured edge stream [E,2] (hub-skewed),
    matching the paper's power-law workload discussion. Same numpy draws
    as the JAX package for the same generator state."""
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w)
    dst = rng.choice(n_nodes, size=n_edges, p=w)
    # avoid self loops by bumping dst
    dst = np.where(dst == src, (dst + 1) % n_nodes, dst)
    return np.stack([src, dst], axis=1).astype(np.int32)
