"""Triplet index construction for directional message passing (DimeNet).

Counterpart of `repro/graph/triplets.py`, host numpy. A triplet (k -> j
-> i) pairs each directed edge e1=(j,i) with every in-edge e2=(k,j) of
its source, k != i, in the reference's order: e1 ascending, and for each
e1 its source's in-edges in stable receiver order. Counts are
data-dependent, so the output is capped at `t_max` and masked.

The reference walks the edges in a Python loop; this builds the same
sequence with array operations, a block of edges at a time, and stops
once `t_max` triplets exist, so a hub's millions of candidate pairs past
the cap are never formed.
"""
from __future__ import annotations

import numpy as np

# candidate (e1, e2) pairs formed at once (before the k != i filter)
_BLOCK_PAIRS = 1 << 22


def build_triplets(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
                   t_max: int):
    """Returns (edge_kj [t_max], edge_ji [t_max], mask [t_max]): int32 edge
    indices and a bool mask of the first T = min(t_max, all) triplets;
    the padding is 0, 0, False. Equal to the reference's output."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    order = np.argsort(receivers, kind="stable")
    sorted_recv = receivers[order]
    starts = np.searchsorted(sorted_recv, np.arange(n_nodes))
    ends = np.searchsorted(sorted_recv, np.arange(n_nodes) + 1)
    lo = starts[senders]                        # per e1: its source's run
    cnt = ends[senders] - lo
    cum = np.cumsum(cnt)
    kj, ji = [], []
    found, e1 = 0, 0
    E = len(senders)
    while e1 < E and found < t_max:
        # a block of edges whose candidates number about _BLOCK_PAIRS
        base = cum[e1] - cnt[e1]
        stop = max(e1 + 1, int(np.searchsorted(cum, base + _BLOCK_PAIRS,
                                               side="right")))
        stop = min(stop, E)
        c = cnt[e1:stop]
        rep = np.repeat(np.arange(e1, stop), c)
        within = np.arange(len(rep)) - np.repeat(np.cumsum(c) - c, c)
        e2 = order[lo[rep] + within]
        keep = senders[e2] != receivers[rep]    # exclude backtracking k == i
        kj.append(e2[keep][:t_max - found])
        ji.append(rep[keep][:t_max - found])
        found += len(kj[-1])
        e1 = stop
    T = found
    out_kj = np.zeros(t_max, np.int32)
    out_ji = np.zeros(t_max, np.int32)
    mask = np.zeros(t_max, bool)
    if T:
        out_kj[:T] = np.concatenate(kj)
        out_ji[:T] = np.concatenate(ji)
    mask[:T] = True
    return out_kj, out_ji, mask


def triplet_count(senders: np.ndarray, receivers: np.ndarray,
                  n_nodes: int) -> int:
    """Exact number of (k->j->i) triplets (without the k != i exclusion)."""
    in_deg = np.bincount(receivers, minlength=n_nodes)
    return int(np.sum(in_deg[senders]))
