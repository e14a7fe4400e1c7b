"""Vertex-cut locality plan + the sharded full-graph GNN train step.

Counterpart of `repro/dist/gnn_locality.py`. The D3-GNN idea applied to
full-graph training: block-partition the vertices over the ranks, place
every edge on its RECEIVER's rank, and materialise the senders a rank
does not own as halo rows fed by a per-layer all_to_all
(`StreamMesh.exchange`). Aggregations stay rank-local (receivers are
always owned), so the only wire traffic is the halo feature rows.

`build_plan` is host numpy; its arrays equal the reference's bit for bit
(halo slots in first-appearance order per (src, dst) pair, edges in
stream order per rank), computed with sorts instead of the reference's
Python loop over edges. `make_locality_train_step` runs on each rank of
a StreamMesh over that rank's block; its loss and update equal the
global single-device step's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import value_and_grad
from repro_torch.graph import segment
from repro_torch.graph.graphs import Graph
from repro_torch.optim import adam, apply_updates, clip_by_global_norm


@dataclass
class LocalityPlan:
    """Static routing tables for one graph snapshot.

    Local sender index space per rank: rows [0, n_loc) are owned
    vertices, row n_loc + p * r_cap + r is halo slot r received from rank
    p.
    """
    n_loc: int                     # owned vertices per rank
    r_cap: int                     # halo rows per (src, dst) rank pair
    senders_local: np.ndarray      # [S, E_cap] int32 into the local buffer
    receivers_local: np.ndarray    # [S, E_cap] int32, < n_loc (owned)
    edge_mask: np.ndarray          # [S, E_cap] bool
    send_idx: np.ndarray           # [S, S, r_cap] int32 owned rows to ship
    send_mask: np.ndarray          # [S, S, r_cap] bool


def _rank_in_group(group_sorted):
    """0, 1, 2, ... within each run of equal values of a sorted array."""
    n = group_sorted.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    start = np.r_[True, group_sorted[1:] != group_sorted[:-1]]
    first = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    return np.arange(n) - first


def build_plan(senders, receivers, n_nodes: int, n_shards: int,
               e_cap: int | None = None,
               r_cap: int | None = None) -> LocalityPlan:
    """Place each edge on its receiver's rank; dedupe halo senders. The
    reference's asserts: n_nodes divisible by the ranks, no (src, dst)
    pair past r_cap halo rows, no rank past e_cap edges."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    S = n_shards
    assert n_nodes % S == 0, f"{n_nodes} nodes not divisible by {S} shards"
    n_loc = n_nodes // S
    own_u, lu = senders // n_loc, senders % n_loc
    own_v, lv = receivers // n_loc, receivers % n_loc
    remote = own_u != own_v

    # halo slots: per (src rank p, dst rank q) pair, its distinct senders
    # in the order of their first remote edge
    key = (own_u[remote] * S + own_v[remote]) * n_loc + lu[remote]
    ukey, first, inv = np.unique(key, return_index=True, return_inverse=True)
    pair = ukey // n_loc
    by_appearance = np.lexsort((first, pair))
    slot_of = np.empty(ukey.shape[0], np.int64)
    slot_of[by_appearance] = _rank_in_group(pair[by_appearance])
    counts = np.bincount(pair, minlength=S * S)

    if r_cap is None:
        r_cap = max(int(counts.max(initial=0)), 1)
    per_shard = np.bincount(own_v, minlength=S)
    if e_cap is None:
        e_cap = max(int(per_shard.max(initial=0)), 1)

    over = np.flatnonzero(counts > r_cap)
    if over.size:
        p, q = divmod(int(over[0]), S)
        raise AssertionError(f"halo overflow: pair ({p},{q}) needs "
                             f"{r_cap + 1} > r_cap={r_cap}")
    send_idx = np.zeros((S, S, r_cap), np.int32)
    send_mask = np.zeros((S, S, r_cap), bool)
    send_idx.reshape(S * S, r_cap)[pair, slot_of] = ukey % n_loc
    send_mask.reshape(S * S, r_cap)[pair, slot_of] = True

    full = np.flatnonzero(per_shard > e_cap)
    if full.size:
        s = int(full[0])
        raise AssertionError(f"shard {s} has {int(per_shard[s])} edges > "
                             f"e_cap={e_cap}")
    sender_local = lu.copy()
    sender_local[remote] = n_loc + own_u[remote] * r_cap + slot_of[inv]
    order = np.argsort(own_v, kind="stable")
    pos = _rank_in_group(own_v[order])
    senders_local = np.zeros((S, e_cap), np.int32)
    receivers_local = np.zeros((S, e_cap), np.int32)
    edge_mask = np.zeros((S, e_cap), bool)
    senders_local[own_v[order], pos] = sender_local[order]
    receivers_local[own_v[order], pos] = lv[order]
    edge_mask[own_v[order], pos] = True
    return LocalityPlan(n_loc=n_loc, r_cap=r_cap,
                        senders_local=senders_local,
                        receivers_local=receivers_local,
                        edge_mask=edge_mask,
                        send_idx=send_idx, send_mask=send_mask)


def rank_batch(plan: LocalityPlan, rank: int, x, labels, label_mask,
               device=None) -> dict:
    """Rank `rank`'s block of the step's batch, as tensors on `device`:
    x [n_loc, d], labels / label_mask [n_loc] (global arrays cut by the
    rank's block of vertices), senders / receivers / edge_mask [E_r] and
    send_idx / send_mask [S, r_cap] (the plan's row for the rank; indices
    int64). E_r is the rank's own edge count: the plan pads every rank
    to e_cap for JAX's static shapes, and a padded slot contributes
    nothing but its compute (a rank holding few edges of a skewed graph
    would run the busiest rank's count)."""
    lo, hi = rank * plan.n_loc, (rank + 1) * plan.n_loc
    n_e = int(plan.edge_mask[rank].sum())       # live slots come first
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a)).to(
        device=device, dtype=dt)
    return {"x": t(x[lo:hi], torch.float32),
            "labels": t(labels[lo:hi], torch.int64),
            "label_mask": t(label_mask[lo:hi], torch.bool),
            "senders": t(plan.senders_local[rank, :n_e], torch.int64),
            "receivers": t(plan.receivers_local[rank, :n_e], torch.int64),
            "edge_mask": t(plan.edge_mask[rank, :n_e]),
            "send_idx": t(plan.send_idx[rank], torch.int64),
            "send_mask": t(plan.send_mask[rank])}


def _halo_exchange(x_own, send_idx, send_mask, mesh):
    """all_to_all the owned rows each peer needs: [S * r_cap, d] halo,
    block p from rank p."""
    S, r_cap = send_idx.shape
    buf = torch.where(send_mask[:, :, None], x_own[send_idx], 0)
    return mesh.exchange(buf.reshape(S * r_cap, -1), kind="halo")


def _pna_local_update(layer, x_full, senders, receivers, edge_mask,
                      n_own: int):
    """PNA layer with the post-MLP restricted to OWNED rows (halo rows
    only feed messages): the full layer computed and sliced would run
    the post linear over every halo row too."""
    x_own = x_full[:n_own]
    m = layer.pre(torch.cat([x_full[senders], x_full[receivers]], dim=-1))
    aggs = torch.cat([
        segment.segment_mean(m, receivers, n_own, edge_mask),
        segment.segment_max(m, receivers, n_own, edge_mask),
        segment.segment_min(m, receivers, n_own, edge_mask),
        segment.segment_std(m, receivers, n_own, edge_mask),
    ], dim=-1)
    deg = segment.segment_count(receivers, n_own, edge_mask)
    logd = torch.log(deg + 1.0)
    amp = (logd / layer.avg_log_deg)[:, None]
    att = (layer.avg_log_deg / torch.clamp(logd, min=1e-6))[:, None]
    scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)
    h = layer.post(torch.cat([x_own, scaled], dim=-1))
    return torch.relu(h) if layer.act else h


def make_locality_train_step(model, n_classes: int, mesh,
                             local_update: bool = False,
                             compute_dtype=None, lr: float = 1e-3,
                             clip: float = 1.0):
    """step(params, opt_state, batch) -> (params', opt_state', loss) on
    this rank of `mesh`, batch its block (`rank_batch`). Each layer's
    input is exchanged for its halo, the layer runs on [owned; halo]
    rows and keeps the owned ones (with `local_update`, PNA layers run
    `_pna_local_update`). The CE sum over the rank's labelled rows is
    differentiated on the rank; the sums and the gradients are
    all_reduced and divided by the all_reduced label count, then
    clip_by_global_norm(clip) and Adam at lr run alike on every rank, so
    the result equals the global-graph step. compute_dtype casts x only;
    the layers promote as JAX's do. `step.grads_fn(params, batch)` is the
    (loss, gradients) before the clip."""
    opt = adam()

    def local_ce_sum(b):
        x = b["x"]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        n_own = x.shape[0]
        for layer in model.layers:
            halo = _halo_exchange(x, b["send_idx"], b["send_mask"], mesh)
            x_full = torch.cat([x, halo.to(x.dtype)], dim=0)
            if local_update and hasattr(layer, "pre"):
                x = _pna_local_update(layer, x_full, b["senders"],
                                      b["receivers"], b["edge_mask"], n_own)
            else:
                g = Graph(senders=b["senders"], receivers=b["receivers"],
                          x=x_full, edge_mask=b["edge_mask"])
                x = layer(g, x_full)[:n_own]
        logits = model.head(x) if n_classes else x
        logp = torch.log_softmax(logits.float(), dim=-1)
        gold = torch.gather(logp, -1, b["labels"][:, None])[:, 0]
        return torch.where(b["label_mask"], -gold, 0.0).sum()

    def grads_fn(params, batch):
        ce_sum, grads = value_and_grad(model, local_ce_sum, params, batch)
        cnt = torch.clamp(mesh.all_reduce(
            batch["label_mask"].float().sum()), min=1.0)
        loss = mesh.all_reduce(ce_sum) / cnt
        return loss, {n: g / cnt
                      for n, g in mesh.all_reduce_grads(grads).items()}

    def step(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        grads, _ = clip_by_global_norm(grads, clip)
        updates, opt_state = opt.update(opt_state, grads, params, lr)
        return apply_updates(params, updates), opt_state, loss

    step.grads_fn = grads_fn
    return step
