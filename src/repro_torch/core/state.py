"""Device-side operator state (the paper's Graph Storage, §4.1/§5.2).

Counterpart of `repro/core/state.py`: every table is [P, cap, ...] with
the rank's P logical parts stacked on the leading axis (all parts under
the LocalRouter, the rank's block of Pl under the MeshRouter). Index
tables are int64 (torch's index type), flags bool, features float32. The
routing plane's per-lane defer rings ride the LayerState as packed wire
rows ([K, W] per rank, K = 0 when the exchange cannot overflow).

JAX's `.at[idx].set(..., mode="drop")` has no torch counterpart: torch
wraps negative indices and raises on out-of-range ones. Every scatter here
therefore goes through a table padded with ONE sentinel row at index
P * cap (`local_index`'s drop target) that is sliced off afterwards.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.dist.wire import init_defer


def local_index(part, slot, part0, n_local_parts: int, stride: int, valid):
    """Guarded flat index for part-addressed records.

    Returns (flat_idx, local_part): flat = (part - part0) * stride + slot
    for rows that are valid AND belong to a locally-owned part, else the
    one-past-the-end sentinel (n_local_parts * stride resp. n_local_parts).
    """
    lp = part - part0
    ok = valid & (lp >= 0) & (lp < n_local_parts)
    flat = torch.where(ok, lp * stride + slot,
                       torch.full_like(lp, n_local_parts * stride))
    return flat, torch.where(ok, lp, torch.full_like(lp, n_local_parts))


def scatter_set(dst, idx, vals):
    """dst (flat [R, ...]) with rows idx set to vals; idx == R drops.
    Valid targets must be unique (duplicates only at the sentinel)."""
    buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    buf[idx] = vals
    return buf[:-1]


def mark_rows(n: int, idx, device):
    """[n] bool flags set at idx (idx == n drops) — scatter of True.
    `index_fill_` takes the scalar as is; `buf[idx] = True` would copy it
    to the device and synchronize with the host on every call."""
    buf = torch.zeros(n + 1, dtype=torch.bool, device=device)
    return buf.index_fill_(0, idx, True)[:-1]


@dataclass(frozen=True)
class TopoState:
    """Shared adjacency + replication tables."""
    e_src_slot: torch.Tensor       # [P, E] local slot of u
    e_dst_slot: torch.Tensor       # [P, E] local slot of v (same part)
    e_dst_mpart: torch.Tensor      # [P, E] master part of v
    e_dst_mslot: torch.Tensor      # [P, E] master slot of v
    e_valid: torch.Tensor          # [P, E] bool
    r_master_slot: torch.Tensor    # [P, R]
    r_rep_part: torch.Tensor       # [P, R]
    r_rep_slot: torch.Tensor       # [P, R]
    r_valid: torch.Tensor          # [P, R] bool
    v_exists: torch.Tensor         # [P, N] bool
    is_master: torch.Tensor        # [P, N] bool
    m_part: torch.Tensor           # [P, N] master coordinate mirror (-1)
    m_slot: torch.Tensor           # [P, N]


@dataclass(frozen=True)
class LayerState:
    """Per-GNN-layer feature/aggregator state (one per GraphStorage op)."""
    feat: torch.Tensor             # [P, N, d_in] layer-input features
    has_feat: torch.Tensor         # [P, N] bool
    x_sent: torch.Tensor           # [P, N, d_in] value last pushed to aggs
    has_sent: torch.Tensor         # [P, N] bool
    agg: torch.Tensor              # [P, N, d_agg] synopsis sums (masters)
    agg_cnt: torch.Tensor          # [P, N] float counts
    red_pending: torch.Tensor      # [P, N] bool  inter-layer delayed reduce
    red_deadline: torch.Tensor     # [P, N] int64
    fwd_pending: torch.Tensor      # [P, N] bool  intra-layer delayed forward
    fwd_deadline: torch.Tensor     # [P, N] int64
    cms: torch.Tensor              # [depth, width] float32 CountMinSketch
    last_touch: torch.Tensor       # [P, N] int64
    # routing-plane backpressure: rows that overflowed a capped
    # all_to_all bucket, re-entering the next tick's exchange first
    bc_defer: torch.Tensor         # [K_b, d_in + 5] f32 round-A lane
    bc_defer_ok: torch.Tensor      # [K_b] bool occupied ring slots
    rmi_defer: torch.Tensor        # [K_r, d_agg + 5] f32 round-B lane
    rmi_defer_ok: torch.Tensor     # [K_r] bool


def init_topo(n_parts: int, edge_cap: int, repl_cap: int, node_cap: int,
              device) -> TopoState:
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    m1 = lambda *s: torch.full(s, -1, dtype=torch.int64, device=device)
    return TopoState(
        e_src_slot=zi(n_parts, edge_cap), e_dst_slot=zi(n_parts, edge_cap),
        e_dst_mpart=zi(n_parts, edge_cap), e_dst_mslot=zi(n_parts, edge_cap),
        e_valid=zb(n_parts, edge_cap),
        r_master_slot=zi(n_parts, repl_cap), r_rep_part=zi(n_parts, repl_cap),
        r_rep_slot=zi(n_parts, repl_cap), r_valid=zb(n_parts, repl_cap),
        v_exists=zb(n_parts, node_cap), is_master=zb(n_parts, node_cap),
        m_part=m1(n_parts, node_cap), m_slot=m1(n_parts, node_cap))


def init_layer(n_parts: int, node_cap: int, d_in: int, d_agg: int, device,
               cms_depth: int = 4, cms_width: int = 2048,
               bc_defer_rows: int = 0, rmi_defer_rows: int = 0) -> LayerState:
    """bc/rmi_defer_rows: this rank's defer-ring rows per lane (0 turns
    backpressure off); the ring row is the lane's packed MsgBatch width,
    d + 5 (part, slot, cnt, src_part, valid; dist/wire.py)."""
    zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    bc_defer, bc_defer_ok = init_defer(bc_defer_rows, d_in + 5, device)
    rmi_defer, rmi_defer_ok = init_defer(rmi_defer_rows, d_agg + 5, device)
    return LayerState(
        feat=zf(n_parts, node_cap, d_in), has_feat=zb(n_parts, node_cap),
        x_sent=zf(n_parts, node_cap, d_in), has_sent=zb(n_parts, node_cap),
        agg=zf(n_parts, node_cap, d_agg), agg_cnt=zf(n_parts, node_cap),
        red_pending=zb(n_parts, node_cap), red_deadline=zi(n_parts, node_cap),
        fwd_pending=zb(n_parts, node_cap), fwd_deadline=zi(n_parts, node_cap),
        cms=zf(cms_depth, cms_width), last_touch=zi(n_parts, node_cap),
        bc_defer=bc_defer, bc_defer_ok=bc_defer_ok,
        rmi_defer=rmi_defer, rmi_defer_ok=rmi_defer_ok)


def apply_edge_batch(topo: TopoState, eb, part0=0) -> TopoState:
    """Scatter new edge records into the adjacency tables; records
    addressed to non-local parts drop."""
    P, E = topo.e_src_slot.shape
    idx, _ = local_index(eb.part, eb.edge_slot, part0, P, E, eb.valid)
    scat = lambda dst, val: scatter_set(dst.reshape(P * E), idx,
                                        val).reshape(P, E)
    return replace(
        topo,
        e_src_slot=scat(topo.e_src_slot, eb.src_slot),
        e_dst_slot=scat(topo.e_dst_slot, eb.dst_slot),
        e_dst_mpart=scat(topo.e_dst_mpart, eb.dst_master_part),
        e_dst_mslot=scat(topo.e_dst_mslot, eb.dst_master_slot),
        e_valid=scat(topo.e_valid, eb.valid))


def apply_repl_batch(topo: TopoState, rb, part0=0) -> TopoState:
    P, R = topo.r_master_slot.shape
    idx, _ = local_index(rb.part, rb.repl_slot, part0, P, R, rb.valid)
    scat = lambda dst, val: scatter_set(dst.reshape(P * R), idx,
                                        val).reshape(P, R)
    # mirror fill: the REPLICA row learns its master coordinate
    N = topo.v_exists.shape[1]
    ridx, _ = local_index(rb.rep_part, rb.rep_slot, part0, P, N, rb.valid)
    return replace(
        topo,
        r_master_slot=scat(topo.r_master_slot, rb.master_slot),
        r_rep_part=scat(topo.r_rep_part, rb.rep_part),
        r_rep_slot=scat(topo.r_rep_slot, rb.rep_slot),
        r_valid=scat(topo.r_valid, rb.valid),
        m_part=scatter_set(topo.m_part.reshape(P * N), ridx,
                           rb.part).reshape(P, N),
        m_slot=scatter_set(topo.m_slot.reshape(P * N), ridx,
                           rb.master_slot).reshape(P, N))


def apply_vertex_batch(topo: TopoState, vb, part0=0) -> TopoState:
    P, N = topo.v_exists.shape
    idx, _ = local_index(vb.part, vb.slot, part0, P, N, vb.valid)
    v_exists = topo.v_exists.reshape(P * N) | mark_rows(P * N, idx,
                                                         idx.device)
    # `.at[].max` of the mastership flag: scatter_reduce "amax" on uint8
    im = torch.cat([topo.is_master.reshape(P * N),
                    torch.zeros(1, dtype=torch.bool, device=idx.device)])
    im = im.to(torch.uint8).scatter_reduce(
        0, idx, vb.is_master.to(torch.uint8), "amax")[:-1].bool()
    # mirror fill: a master row's master coordinate is itself
    idx_m, _ = local_index(vb.part, vb.slot, part0, P, N,
                           vb.valid & vb.is_master)
    return replace(
        topo, v_exists=v_exists.reshape(P, N), is_master=im.reshape(P, N),
        m_part=scatter_set(topo.m_part.reshape(P * N), idx_m,
                           vb.part).reshape(P, N),
        m_slot=scatter_set(topo.m_slot.reshape(P * N), idx_m,
                           vb.slot).reshape(P, N))


def defer_occupancy(ls: LayerState):
    """Exact occupied-slot counts of a layer's routing defer rings as
    (broadcast_rows, rmi_rows) 0-d int64 tensors: the oracle the telemetry
    plane's `occ_bc_defer` / `occ_rmi_defer` gauges must reproduce."""
    return ls.bc_defer_ok.sum(), ls.rmi_defer_ok.sum()
