"""Synthetic streams mirroring the paper's datasets (temporal edge lists +
node features).

Counterpart of `repro/data/streams.py`: the graph streams and the LM
token batches. The paper streams temporal
edge-list files (sx-superuser, reddit-hyperlink, stackoverflow,
ogb-products, wikikg90Mv2) as per-edge addition events ordered by
timestamp, with node features as a feature stream. These generators
produce the same event discipline at arbitrary scale: hub-skewed
(power-law) topology, timestamped edges, features delivered with a
vertex's first appearance (or later by `feature_lag`). The numpy draws
are the JAX package's, call for call, so one seed gives the same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.graph.graphs import powerlaw_edges


@dataclass
class TemporalStream:
    edges: np.ndarray           # [E, 2] ordered by timestamp
    timestamps: np.ndarray      # [E]
    feats: dict                 # vid -> feature vector
    n_nodes: int


def temporal_stream(seed: int = 0, n_nodes: int = 1000, n_edges: int = 10000,
                    d_feat: int = 16, alpha: float = 1.3,
                    burstiness: float = 0.0) -> TemporalStream:
    """Power-law temporal graph stream. `burstiness` > 0 concentrates
    timestamps (the paper's seasonality/hot-region workload shifts)."""
    rng = np.random.default_rng(seed)
    edges = powerlaw_edges(rng, n_nodes, n_edges, alpha)
    gaps = rng.exponential(1.0, n_edges)
    if burstiness > 0:
        bursts = rng.random(n_edges) < burstiness
        gaps = np.where(bursts, gaps * 0.01, gaps)
    ts = np.cumsum(gaps)
    feats = {v: rng.normal(size=d_feat).astype(np.float32)
             for v in range(n_nodes)}
    return TemporalStream(edges=edges, timestamps=ts, feats=feats,
                          n_nodes=n_nodes)


def edge_stream(stream: TemporalStream,
                tick_edges: int) -> Iterator[np.ndarray]:
    for lo in range(0, len(stream.edges), tick_edges):
        yield stream.edges[lo: lo + tick_edges]


def feature_stream(stream: TemporalStream, tick_edges: int,
                   feature_lag: int = 0) -> Iterator[list]:
    """Feature events aligned with a vertex's first appearance, optionally
    delayed by `feature_lag` ticks (exercises msgReady gating)."""
    seen: set = set()
    pending: list = []
    for i, lo in enumerate(range(0, len(stream.edges), tick_edges)):
        chunk = stream.edges[lo: lo + tick_edges]
        new = []
        for v in np.unique(chunk):
            v = int(v)
            if v not in seen:
                seen.add(v)
                new.append((v, stream.feats[v]))
        pending.append(new)
        if i >= feature_lag:
            yield pending.pop(0)
        else:
            yield []
    while pending:
        yield pending.pop(0)


def token_batches(seed: int, vocab: int, batch: int, seq: int,
                  n_batches: int) -> Iterator[tuple]:
    """Synthetic LM (tokens, labels) batches with a Zipfian marginal, as
    numpy int32 arrays [batch, seq]; labels are the tokens shifted left
    by one (wrapping), as the JAX package's generator gives them."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    for _ in range(n_batches):
        toks = rng.choice(vocab, size=(batch, seq), p=p).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        yield toks, labels
