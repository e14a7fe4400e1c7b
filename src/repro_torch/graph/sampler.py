"""Fanout neighbor sampler (GraphSAGE-style) for the `minibatch_lg` shape.

Counterpart of `repro/graph/sampler.py`, host numpy over a CSR of
in-edges: for each seed, sample up to fanout[0] in-neighbors; for each of
those, fanout[1]; etc. Returns a subgraph padded to static capacities
with remapped local node ids. For the same numpy Generator state the
output equals the reference's (the same draws in the same order).

The capacities for a fanout (f1, f2, ...) and B seeds:
    layer0 nodes: B, layer1: B*f1, layer2: B*f1*f2, ...
    edges: B*f1 + B*f1*f2 + ...
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graph.graphs import Graph


@dataclass
class CSRGraph:
    """In-edge CSR: for node v, senders of its in-edges are
    indices[indptr[v]:indptr[v+1]]."""
    indptr: np.ndarray
    indices: np.ndarray
    n_nodes: int

    @staticmethod
    def from_edges(senders: np.ndarray, receivers: np.ndarray, n_nodes: int):
        order = np.argsort(receivers, kind="stable")
        sorted_send = senders[order]
        counts = np.bincount(receivers, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=sorted_send, n_nodes=n_nodes)


def sample_capacities(batch_nodes: int, fanout: tuple[int, ...]):
    node_caps = [batch_nodes]
    edge_cap = 0
    for f in fanout:
        edge_cap += node_caps[-1] * f
        node_caps.append(node_caps[-1] * f)
    return sum(node_caps), edge_cap


def sample_subgraph(rng: np.random.Generator, csr: CSRGraph,
                    seeds: np.ndarray, fanout: tuple[int, ...],
                    features: np.ndarray | None = None):
    """Multi-hop fanout sample. Returns (Graph of CPU tensors, local seed
    ids [B] int32, global id of each local node [max_nodes] int64): the
    graph's senders/receivers are int64 local ids, edge_mask and node_mask
    mark the sampled prefix, x the features' rows (zeros [max_nodes, 1]
    without features)."""
    max_nodes, max_edges = sample_capacities(len(seeds), fanout)
    local_of = {}                       # global id -> local id
    nodes = []                          # global ids by local id

    def local(gid: int) -> int:
        lid = local_of.get(gid)
        if lid is None:
            lid = len(nodes)
            local_of[gid] = lid
            nodes.append(gid)
        return lid

    senders, receivers = [], []
    frontier = [local(int(s)) for s in seeds]
    frontier_g = [int(s) for s in seeds]
    for f in fanout:
        nxt_l, nxt_g = [], []
        for lv, gv in zip(frontier, frontier_g):
            lo, hi = csr.indptr[gv], csr.indptr[gv + 1]
            deg = hi - lo
            if deg == 0:
                continue
            k = min(f, int(deg))
            picks = rng.choice(deg, size=k, replace=False) + lo
            for p in picks:
                gu = int(csr.indices[p])
                lu = local(gu)
                senders.append(lu)
                receivers.append(lv)
                nxt_l.append(lu)
                nxt_g.append(gu)
        frontier, frontier_g = nxt_l, nxt_g

    N, E = len(nodes), len(senders)
    s = np.zeros(max_edges, np.int64)
    r = np.zeros(max_edges, np.int64)
    emask = np.zeros(max_edges, bool)
    s[:E] = senders
    r[:E] = receivers
    emask[:E] = True
    nmask = np.zeros(max_nodes, bool)
    nmask[:N] = True
    gids = np.array(nodes + [0] * (max_nodes - N), np.int64)
    if features is not None:
        x = np.zeros((max_nodes, features.shape[1]), features.dtype)
        x[:N] = features[gids[:N]]
    else:
        x = np.zeros((max_nodes, 1), np.float32)
    g = Graph(senders=torch.from_numpy(s), receivers=torch.from_numpy(r),
              x=torch.from_numpy(x), edge_mask=torch.from_numpy(emask),
              node_mask=torch.from_numpy(nmask))
    return g, np.arange(len(seeds), dtype=np.int32), gids
