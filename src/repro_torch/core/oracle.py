"""Static full-graph oracle for exactness checks.

Counterpart of `repro/core/oracle.py`: the streaming sink must equal the
same model run statically on the final graph snapshot. Edges form a
multiset (duplicates count); only vertices whose features were streamed
emit messages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.graphs import Graph


def build_snapshot(edges: np.ndarray, feats: dict, d_in: int, n_nodes: int,
                   device, dtype=torch.float32):
    """Graph from the final event log + which nodes have features."""
    x = np.zeros((n_nodes, d_in), np.float32)
    has = np.zeros(n_nodes, bool)
    for vid, vec in feats.items():
        x[vid] = vec
        has[vid] = True
    emask = has[edges[:, 0]]            # only featured sources emit
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(device)
    g = Graph(senders=as_t(edges[:, 0], torch.int64),
              receivers=as_t(edges[:, 1], torch.int64),
              x=as_t(x).to(dtype), edge_mask=as_t(emask),
              node_mask=as_t(has))
    return g, has


@torch.no_grad()
def oracle_embeddings(model, g: Graph):
    """Static forward of the same layer stack on the snapshot (run the
    model in float64 with a float64 snapshot for a tighter reference)."""
    x = g.x
    for layer in model.layers:
        x = layer(g, x)
    return x
