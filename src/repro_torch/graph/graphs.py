"""Graph container (struct of tensors), the synthetic graphs and the
power-law edge stream.

Counterpart of `repro/graph/graphs.py`. Directed edges run sender ->
receiver; messages aggregate at receivers (the paper's N_in(v)
convention). Batched small graphs (the `molecule` shape) are disjoint
unions with a `graph_ids` vector. The synthetic graphs draw from a numpy
Generator (torch cannot reproduce `jax.random`), so a test can draw the
same arrays for both packages; they come back as CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
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
    edge_attr: Optional[torch.Tensor] = None   # [E, de]
    pos: Optional[torch.Tensor] = None         # [N, 3]
    graph_ids: Optional[torch.Tensor] = None   # [N] int64 (batched graphs)
    n_graphs: int = 1

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    def replace(self, **kw) -> "Graph":
        return replace(self, **kw)


def in_degree(g: Graph) -> torch.Tensor:
    ones = torch.ones(g.n_edges, dtype=torch.float32, device=g.x.device)
    if g.edge_mask is not None:
        ones = torch.where(g.edge_mask, ones, 0.0)
    return torch.zeros(g.n_nodes, dtype=torch.float32,
                       device=g.x.device).index_add_(0, g.receivers, ones)


def _ids(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64))


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def erdos_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                d_feat: int, with_pos: bool = False) -> Graph:
    """Synthetic random graph: uniform senders and receivers, standard
    normal features and (with_pos) positions 3 * N(0, 1), drawn from `rng`
    in that order."""
    senders = rng.integers(0, n_nodes, n_edges)
    receivers = rng.integers(0, n_nodes, n_edges)
    x = rng.normal(size=(n_nodes, d_feat))
    pos = 3.0 * rng.normal(size=(n_nodes, 3)) if with_pos else None
    return Graph(senders=_ids(senders), receivers=_ids(receivers), x=_f32(x),
                 pos=None if pos is None else _f32(pos))


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


def batch_molecules(rng: np.random.Generator, n_graphs: int, nodes_per: int,
                    edges_per: int, d_feat: int) -> Graph:
    """Disjoint union of `n_graphs` random molecule-sized graphs with 3D
    positions 2 * N(0, 1): each graph's edges join uniform nodes of that
    graph. Draws senders, receivers, x, pos from `rng` in that order."""
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    offs_n = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    senders = rng.integers(0, nodes_per, E) + offs_n
    receivers = rng.integers(0, nodes_per, E) + offs_n
    x = rng.normal(size=(N, d_feat))
    pos = 2.0 * rng.normal(size=(N, 3))
    gids = np.repeat(np.arange(n_graphs), nodes_per)
    return Graph(senders=_ids(senders), receivers=_ids(receivers), x=_f32(x),
                 pos=_f32(pos), graph_ids=_ids(gids), n_graphs=n_graphs)
