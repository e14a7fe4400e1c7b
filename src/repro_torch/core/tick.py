"""The per-layer micro-tick: streaming (Alg. 1) and windowed (Alg. 2)
forward pass.

Counterpart of `repro/core/tick.py`, under the LocalRouter or the 1-D
MeshRouter, in exact mode (delta_eps = 0) and delta-gated mode. One tick
= two routing rounds, four part-local stages with a Router delivery
between them:

  round_a_apply : master-addressed feature updates land at local masters
                  (delivery.deliver_set); selectiveBroadcast records for
                  changed masters are emitted as a part-addressed MsgBatch.
       -- router.route_lanes --
  round_b_emit  : delivered broadcasts apply at replicas; per-vertex
                  feature deltas and new-edge messages become aggregator
                  RMI records (delta, dcnt) addressed to destination
                  masters (reduce / replace / remove are all additive).
                  With delta_eps > 0 a source whose un-sent delta passes
                  its aggregator's gate (core/aggregators.GATES) is
                  suppressed, and the RMIs are coalesced per destination
                  (events.coalesce_msg_batch) before the exchange.
       -- router.route_lanes --
                  each route_lanes call is one packed all_to_all on the
                  mesh, its buckets capped by route_cap; overflow defers
                  into the LayerState's rings and re-enters next tick.
  apply_rmis    : ONE delivery (delivery.deliver_add) applies any RMI mix,
                  after canon_msg_batch puts the records in canonical
                  (destination, source part) order.
  forward_psi   : dirty masters run the update (psi) under the intra-layer
                  window into a per-part capacity-limited outbox; the
                  aggregator read goes through delivery.agg_read_rows.

Windowing replaces "emit now" with deadline tables: the inter-layer window
delays the reduce of a source vertex (red_*), the intra-layer window the
forward of a master (fwd_*). Counts follow Algorithm 1 exactly, so an
aggregator count equals the number of in-edges whose source feature has
been seen — the static oracle's in-degree once quiescent.

Every stage sees only the rank's LOCAL block of parts ([P_loc, ...], global
part ids offset by `router.part0()`), so the same body runs on one device
and on every rank of the mesh. Scalar TickStats are reduced over the ranks
with one `router.psum` per layer tick; the per-part `busy` vector stays
local. Apart from the mesh's collectives, no function reads a value back
to the host, so on one device the super-tick driver queues T ticks with
one host sync. The state is treated functionally (new tensors out), as in
the JAX package. While torch's profiler is on, the four stages of a layer
tick run inside the ranges `d3.layer.round_a`, `d3.layer.round_b`,
`d3.layer.rmi_apply` and `d3.layer.forward` (telemetry/spans.py).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from repro_torch.core import windowing as win
from repro_torch.core.aggregators import GATES
from repro_torch.core.delivery import KernelDelivery
from repro_torch.core.events import (EdgeBatch, FeatBatch, MsgBatch,
                                     ReplBatch, coalesce_msg_batch,
                                     concat_msg_batches)
from repro_torch.core.state import (LayerState, TopoState, local_index,
                                    mark_rows)
from repro_torch.dist.router import LocalRouter, add_receipts
from repro_torch.telemetry import spans


@dataclass(frozen=True)
class TickStats:
    """Per-layer tick counters: 0-d int64 tensors (reduced over the mesh)
    plus the rank's [P_loc] busy vector. Field meanings as in the JAX
    package; the wire counters are zero under the LocalRouter, the
    suppression counter zero in exact mode. The four occupancy gauges
    (occ_bc_defer, occ_rmi_defer, route_peak, outbox_part_peak) carry
    exact values only with the telemetry plane on, zeros otherwise: the
    end-of-tick defer-ring populations summed over the ranks, the peak
    per-destination route demand before the cap and the peak per-part
    outbox demand before the quota, maxed over the ranks."""
    broadcast_msgs: torch.Tensor     # round-A replica messages
    reduce_msgs: torch.Tensor        # round-B aggregator RMIs routed
    cross_part_msgs: torch.Tensor    # messages leaving their part
    emitted: torch.Tensor            # forward emissions to the next layer
    dropped: torch.Tensor            # emissions deferred by outbox capacity
    wire_rows: torch.Tensor
    route_deferred: torch.Tensor
    route_dropped: torch.Tensor
    n_suppressed: torch.Tensor
    occ_bc_defer: torch.Tensor
    occ_rmi_defer: torch.Tensor
    route_peak: torch.Tensor
    outbox_part_peak: torch.Tensor
    busy: torch.Tensor               # [P] per-part processed-event proxy


SCALAR_FIELDS = tuple(f.name for f in fields(TickStats) if f.name != "busy")


def zero_stats(n_parts: int, device) -> TickStats:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return TickStats(**{k: z for k in SCALAR_FIELDS},
                     busy=torch.zeros(n_parts, dtype=torch.int64,
                                      device=device))


def add_stats(a: TickStats, b: TickStats) -> TickStats:
    return TickStats(**{f.name: getattr(a, f.name) + getattr(b, f.name)
                        for f in fields(TickStats)})


def _count_parts(busy, lp):
    """busy.at[lp].add(1, mode="drop"): lp == P drops."""
    P = busy.shape[0]
    return busy + torch.zeros(P + 1, dtype=busy.dtype,
                              device=busy.device).index_add_(
        0, lp, torch.ones_like(lp))[:P]


# ===================================================== compute-plane stages

def round_a_apply(topo: TopoState, ls: LayerState, inbox: FeatBatch,
                  new_repl: ReplBatch, part0, delivery):
    """Round A: apply the inbox at local masters and build the broadcast
    MsgBatch for replication records whose master changed.

    Returns (feat_flat, changed, has_feat, bcast, busy, n_bcast, n_cross).
    """
    P, N, d_in = ls.feat.shape
    dev = ls.feat.device
    busy = torch.zeros(P, dtype=torch.int64, device=dev)

    in_idx, in_lp = local_index(inbox.part, inbox.slot, part0, P, N,
                                inbox.valid)
    feat_flat, changed = delivery.deliver_set(
        ls.feat.reshape(P * N, d_in), in_idx, inbox.feat)
    has_feat = ls.has_feat.reshape(P * N) | changed
    busy = _count_parts(busy, in_lp)

    # replica-creation sync: a NEW replica immediately receives its
    # master's current state — mark the master changed so the broadcast
    # below covers the new record
    nr_idx, _ = local_index(new_repl.part, new_repl.master_slot, part0, P, N,
                            new_repl.valid)
    nr_push = (nr_idx < P * N) & has_feat[torch.clamp(nr_idx,
                                                      max=P * N - 1)]
    changed = changed | mark_rows(
        P * N, torch.where(nr_push, nr_idx, torch.full_like(nr_idx, P * N)),
        dev)

    # broadcast emission: replication records whose master changed
    pp = torch.arange(P, device=dev)[:, None]
    r_midx = (pp * N + topo.r_master_slot).reshape(-1)            # [P*R]
    r_live = topo.r_valid & changed[r_midx].reshape(topo.r_valid.shape)
    live = r_live.reshape(-1)
    bcast = MsgBatch(
        part=topo.r_rep_part.reshape(-1), slot=topo.r_rep_slot.reshape(-1),
        vec=feat_flat[r_midx].masked_fill_(~live[:, None], 0.0),
        cnt=torch.zeros(live.shape[0], dtype=torch.float32, device=dev),
        src_part=(part0 + pp).expand(r_live.shape).reshape(-1),
        valid=live)
    n_bcast = r_live.sum()
    n_cross = (r_live & (topo.r_rep_part != part0 + pp)).sum()
    return feat_flat, changed, has_feat, bcast, busy, n_bcast, n_cross


def round_b_emit(layer, topo: TopoState, ls: LayerState, feat_flat, changed,
                 has_feat, bcast_d: MsgBatch, new_edges: EdgeBatch, now,
                 wconf: win.WindowConfig, part0, busy, freq, delivery,
                 delta_eps: float = 0.0):
    """Round B: apply DELIVERED broadcasts at local replicas, decide which
    touched vertices send this tick (inter-layer window), and emit the
    tick's aggregator RMI records.

    delta_eps > 0 gates the re-emissions: a candidate that has sent before
    and whose message moved by no more than eps under its aggregator's
    gate is SUPPRESSED — it leaves the pending set without advancing
    x_sent, so the residual stays accumulated against the last value sent
    and is re-gated on its next touch. At 0 the gate is not built.

    Returns (feat_flat, changed, has_feat, x_sent_flat, has_sent,
    red_pending, red_deadline, rmis, busy, n_reduce, n_cross, n_supp):
    n_supp counts the valid out-edges of suppressed sources.
    """
    P, N, d_in = ls.feat.shape
    dev = feat_flat.device

    b_idx, b_lp = local_index(bcast_d.part, bcast_d.slot, part0, P, N,
                              bcast_d.valid)
    feat_flat, b_touched = delivery.deliver_set(feat_flat, b_idx,
                                                bcast_d.vec)
    changed = changed | b_touched
    has_feat = has_feat | b_touched
    busy = _count_parts(busy, b_lp)

    x_sent_flat = ls.x_sent.reshape(P * N, d_in)
    has_sent = ls.has_sent.reshape(P * N)

    # new-edge RMIs (addElement(e), Alg. 1) — emitted by the part that
    # owns the edge record (it holds the source replica's x_sent)
    e_sidx, e_lp = local_index(new_edges.part, new_edges.src_slot, part0,
                               P, N, new_edges.valid)
    e_gather = torch.clamp(e_sidx, max=P * N - 1)
    e_ready = (e_sidx < P * N) & has_sent[e_gather]              # msgReady
    e_msg = layer.message(x_sent_flat[e_gather])
    busy = _count_parts(busy, e_lp)

    # per-vertex reduce/replace deltas under the inter-layer window
    red_pending = ls.red_pending.reshape(P * N) | changed
    red_deadline = ls.red_deadline.reshape(P * N)
    touched_deadline = win.next_deadline(
        wconf, now, red_deadline, ls.red_pending.reshape(P * N), freq)
    red_deadline = torch.where(changed, touched_deadline, red_deadline)
    # STREAMING evicts everything pending (the drain path of flush())
    cand = red_pending if wconf.kind == win.STREAMING else \
        red_pending & (red_deadline <= now)
    # delta = phi(x) - phi(x_sent) if has_sent else (phi(x), +1)
    msg_new = layer.message(feat_flat)
    msg_old = layer.message(x_sent_flat)
    if delta_eps > 0.0:
        gate = GATES[getattr(layer, "agg_kind", "mean")]
        suppress = cand & has_sent & gate(msg_new, msg_old, delta_eps)
        send = cand & ~suppress
    else:
        suppress = None
        send = cand
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta_vec = torch.where(
        send[:, None], msg_new - torch.where(has_sent[:, None], msg_old, zero),
        zero)
    delta_cnt = torch.where(send, torch.where(has_sent, zero, 1.0), zero)

    # per-edge gather of source deltas -> destination masters
    pp = torch.arange(P, device=dev)[:, None]
    o_sidx = (pp * N + topo.e_src_slot).reshape(-1)               # [P*E]
    o_live2 = topo.e_valid & send[o_sidx].reshape(topo.e_valid.shape)
    o_live = o_live2.reshape(-1)
    e_rmis = MsgBatch(
        part=new_edges.dst_master_part, slot=new_edges.dst_master_slot,
        vec=e_msg.masked_fill_(~e_ready[:, None], 0.0),
        cnt=e_ready.to(torch.float32), src_part=new_edges.part,
        valid=e_ready)
    o_rmis = MsgBatch(
        part=topo.e_dst_mpart.reshape(-1), slot=topo.e_dst_mslot.reshape(-1),
        vec=delta_vec[o_sidx].masked_fill_(~o_live[:, None], 0.0),
        cnt=delta_cnt[o_sidx] * o_live,
        src_part=(part0 + pp).expand(o_live2.shape).reshape(-1),
        valid=o_live)
    rmis = concat_msg_batches(e_rmis, o_rmis)
    n_reduce = e_ready.sum() + o_live.sum()
    n_cross = ((e_ready & (new_edges.dst_master_part != new_edges.part)).sum()
               + (o_live2 & (topo.e_dst_mpart != part0 + pp)).sum())

    # commit send bookkeeping; suppressed vertices leave the pending set
    # WITHOUT advancing x_sent
    x_sent_flat = torch.where(send[:, None], feat_flat, x_sent_flat)
    has_sent = has_sent | send
    if suppress is None:
        red_pending = red_pending & ~send
        n_supp = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        red_pending = red_pending & ~send & ~suppress
        # the saved message volume: out-edge RMIs the gate skipped
        n_supp = (topo.e_valid
                  & suppress[o_sidx].reshape(topo.e_valid.shape)).sum()
    return (feat_flat, changed, has_feat, x_sent_flat, has_sent,
            red_pending, red_deadline, rmis, busy, n_reduce, n_cross,
            n_supp)


def canon_msg_batch(b: MsgBatch, part0, P_loc: int, N: int,
                    n_parts: int) -> MsgBatch:
    """Deterministic delivery: reorder a DELIVERED additive batch into the
    canonical (local destination index, source part) order with a stable
    sort. Invalid rows carry the sentinel index and sort to the back."""
    idx, _ = local_index(b.part, b.slot, part0, P_loc, N, b.valid)
    key = idx * n_parts + torch.clamp(b.src_part, 0, n_parts - 1)
    order = torch.sort(key, stable=True).indices
    return MsgBatch(part=b.part[order], slot=b.slot[order],
                    vec=b.vec[order], cnt=b.cnt[order],
                    src_part=b.src_part[order], valid=b.valid[order])


def apply_rmis(ls: LayerState, rmis_d: MsgBatch, part0, busy, delivery):
    """Apply DELIVERED aggregator RMIs at local masters: one delivery
    regardless of the reduce/replace/remove mix.

    Returns (agg_flat, cnt_flat, agg_dirty, busy)."""
    P, N, d_agg = ls.agg.shape
    idx, lp = local_index(rmis_d.part, rmis_d.slot, part0, P, N,
                          rmis_d.valid)
    agg_flat, cnt_flat, agg_dirty = delivery.deliver_add(
        ls.agg.reshape(P * N, d_agg), ls.agg_cnt.reshape(P * N), idx,
        rmis_d.vec, rmis_d.cnt)
    return agg_flat, cnt_flat, agg_dirty, _count_parts(busy, lp)


def forward_psi(layer, topo: TopoState, ls: LayerState, feat_flat, has_feat,
                agg_flat, cnt_flat, agg_dirty, changed, now,
                wconf: win.WindowConfig, outbox_cap_pp: int, part0, busy,
                freq, delivery, demand: bool = False):
    """Forward/update phase (psi) under the intra-layer window, with a
    PER-PART capacity-limited outbox (the first `outbox_cap_pp` evicted
    slots per part emit; the rest stay pending -> backpressure).

    Returns (fwd_pending, fwd_deadline, outbox, busy, n_emit, n_drop,
    n_demand_pp): n_demand_pp is the max per-part eviction demand before
    the quota (the telemetry gauge), computed only when `demand`, else
    None."""
    P, N, _ = ls.feat.shape
    dev = feat_flat.device
    is_m = topo.is_master.reshape(P * N)
    dirty = (agg_dirty | (changed & is_m)) & has_feat & is_m
    fwd_pending = ls.fwd_pending.reshape(P * N) | dirty
    fwd_deadline = ls.fwd_deadline.reshape(P * N)
    fwd_touch_dl = win.next_deadline(
        wconf, now, fwd_deadline, ls.fwd_pending.reshape(P * N), freq)
    fwd_deadline = torch.where(dirty, fwd_touch_dl, fwd_deadline)
    evict = fwd_pending if wconf.kind == win.STREAMING else \
        fwd_pending & (fwd_deadline <= now)

    n_demand_pp = (evict.reshape(P, N).sum(dim=1).max() if demand
                   else None)
    slots = torch.arange(N, device=dev)[None, :]
    order = torch.where(evict.reshape(P, N), slots, N)             # [P,N]
    k = max(1, min(outbox_cap_pp, N))
    # the k smallest evicting slots per part, ascending; ties among the
    # invalid picks (value N) do not matter — only values are used
    picked = torch.topk(order, k, dim=1, largest=False, sorted=True).values
    picked_valid = picked < N                                      # [P,k]
    picked = torch.clamp(picked, max=N - 1)
    flat_picked = (torch.arange(P, device=dev)[:, None] * N
                   + picked).reshape(-1)
    # invalid picks go to the OOB sentinel, NOT clamped onto slot N-1: a
    # clamped duplicate could erase a real emission's mark
    mask_idx = torch.where(picked_valid.reshape(-1), flat_picked,
                           torch.full_like(flat_picked, P * N))
    emitted_mask = mark_rows(P * N, mask_idx, dev)
    n_emit = emitted_mask.sum()
    n_drop = (evict & ~emitted_mask).sum()

    x_self = feat_flat[flat_picked]
    agg_read = delivery.agg_read_rows(agg_flat, cnt_flat, flat_picked)
    x_out = layer.update(x_self, agg_read)
    out_part = (part0 + torch.arange(P, device=dev)[:, None]).expand(
        picked.shape)
    outbox = FeatBatch(part=out_part.reshape(-1), slot=picked.reshape(-1),
                       feat=x_out, valid=picked_valid.reshape(-1))
    fwd_pending = fwd_pending & ~emitted_mask
    busy = busy + picked_valid.sum(dim=1)
    return (fwd_pending, fwd_deadline, outbox, busy, n_emit, n_drop,
            n_demand_pp)


# ======================================================== the full tick body

@torch.no_grad()
def layer_tick_body(layer, topo: TopoState, ls: LayerState, inbox: FeatBatch,
                    new_edges: EdgeBatch, new_repl: ReplBatch, now,
                    wconf: win.WindowConfig, outbox_cap: int, router=None,
                    delivery=None, extra_lane=None, delta_eps: float = 0.0,
                    telemetry: bool = False):
    """Advance one GNN layer by one tick.

    `layer` supplies message/update (phi/psi), e.g. graph/sage.SAGELayer;
    `router` owns cross-part transport (default: LocalRouter over the full
    part axis); `delivery` how routed records land in state (default: the
    kernel backend). `now` is a 0-d int64 tensor. `outbox_cap` is the
    GLOBAL per-tick emission budget; each part gets outbox_cap //
    router.n_parts slots.

    extra_lane: optional (batch, (defer_rows, defer_ok)) — one more
    part-addressed lane sent in this layer's round-B exchange (the same
    all_to_all as the RMI lane). The pipeline rides the query plane's
    link-score wire on layer 0 this way; its wire rows count into this
    layer's TickStats.

    delta_eps: delta-gated propagation (round_b_emit). In approximate mode
    (> 0) the RMIs are also coalesced per destination before the routing
    plane (after the stats count them); coalescing reorders f32 sums,
    which is why exact mode (0) skips it and keeps its program.

    telemetry: the TickStats occupancy gauges carry exact values (the
    rings' populations join the one psum of the counters, the two peaks
    take one more max-reduction over the ranks); off, they are zeros and
    the tick launches nothing for them.

    Returns (new LayerState, outbox FeatBatch, TickStats, extra_out):
    extra_out is None, or (delivered extra lane, its new defer ring).
    """
    P, N, d_in = ls.feat.shape
    dev = ls.feat.device
    if router is None:
        router = LocalRouter(n_parts=P)
    if delivery is None:
        delivery = KernelDelivery()
    part0 = router.part0()
    cap_pp = max(1, outbox_cap // router.n_parts)

    keys = part0 * N + torch.arange(P * N, device=dev)    # global CMS keys
    freq = win.cms_query(ls.cms, keys) if wconf.kind == win.ADAPTIVE \
        else torch.zeros(P * N, dtype=torch.float32, device=dev)

    # ---- Round A: apply inbox at masters, emit + route the broadcast
    with spans.region("layer.round_a"):
        (feat_flat, changed, has_feat, bcast, busy,
         n_bcast, bcast_cross) = round_a_apply(topo, ls, inbox, new_repl,
                                               part0, delivery)
        (bcast_d,), (bc_defer,), rcpt = router.route_lanes(
            (bcast,), ((ls.bc_defer, ls.bc_defer_ok),))

    # ---- Round B: apply broadcast at replicas, emit + route the RMIs
    with spans.region("layer.round_b"):
        (feat_flat, changed, has_feat, x_sent_flat, has_sent, red_pending,
         red_deadline, rmis, busy, n_reduce, red_cross,
         n_supp) = round_b_emit(
            layer, topo, ls, feat_flat, changed, has_feat, bcast_d,
            new_edges, now, wconf, part0, busy, freq, delivery,
            delta_eps=delta_eps)
        if delta_eps > 0.0:
            rmis = coalesce_msg_batch(rmis, N, delivery)
        rmi_defer_in = (ls.rmi_defer, ls.rmi_defer_ok)
        if extra_lane is None:
            (rmis_d,), (rmi_defer,), rcpt_b = router.route_lanes(
                (rmis,), (rmi_defer_in,))
            extra_out = None
        else:
            xbatch, xdefer = extra_lane
            (rmis_d, extra_d), (rmi_defer, xdefer_new), rcpt_b = \
                router.route_lanes((rmis, xbatch), (rmi_defer_in, xdefer))
            extra_out = (extra_d, xdefer_new)
        rcpt = add_receipts(rcpt, rcpt_b)

    # ---- apply RMIs at local masters, in canonical order
    with spans.region("layer.rmi_apply"):
        rmis_d = canon_msg_batch(rmis_d, part0, P, N, router.n_parts)
        agg_flat, cnt_flat, agg_dirty, busy = apply_rmis(ls, rmis_d, part0,
                                                         busy, delivery)

    # ---- forward/update phase (psi), intra-layer window
    with spans.region("layer.forward"):
        (fwd_pending, fwd_deadline, outbox, busy, n_emit, n_drop,
         n_demand_pp) = forward_psi(
            layer, topo, ls, feat_flat, has_feat, agg_flat, cnt_flat,
            agg_dirty, changed, now, wconf, cap_pp, part0, busy, freq,
            delivery, demand=telemetry)

    # ---- adaptive-session CMS update
    cms = ls.cms
    if wconf.kind == win.ADAPTIVE:
        touch_keys = torch.where(changed, keys, 0)
        delta = win.cms_delta(cms.shape, touch_keys,
                              changed.to(torch.float32))
        cms = cms * wconf.cms_decay + router.psum(delta)

    d_agg = agg_flat.shape[-1]
    new_ls = LayerState(
        feat=feat_flat.reshape(P, N, d_in), has_feat=has_feat.reshape(P, N),
        x_sent=x_sent_flat.reshape(P, N, d_in),
        has_sent=has_sent.reshape(P, N),
        agg=agg_flat.reshape(P, N, d_agg), agg_cnt=cnt_flat.reshape(P, N),
        red_pending=red_pending.reshape(P, N),
        red_deadline=red_deadline.reshape(P, N),
        fwd_pending=fwd_pending.reshape(P, N),
        fwd_deadline=fwd_deadline.reshape(P, N), cms=cms,
        last_touch=torch.where(changed, now,
                               ls.last_touch.reshape(P * N)).reshape(P, N),
        bc_defer=bc_defer[0], bc_defer_ok=bc_defer[1],
        rmi_defer=rmi_defer[0], rmi_defer_ok=rmi_defer[1])
    # the scalar counters reduced over the ranks in ONE collective (with
    # telemetry, the end-of-tick ring populations ride it)
    counters = [n_bcast, n_reduce, bcast_cross + red_cross, n_emit, n_drop,
                rcpt.rows, rcpt.deferred, rcpt.dropped, n_supp]
    if telemetry:
        counters += [bc_defer[1].sum(), rmi_defer[1].sum()]
    g = router.psum(torch.stack(counters).to(torch.int64))
    if telemetry:
        occ_bc, occ_rmi = g[9], g[10]
        route_peak, outbox_pp = router.pmax(torch.stack(
            [rcpt.peak, n_demand_pp]).to(torch.int64))
    else:
        occ_bc = occ_rmi = route_peak = outbox_pp = torch.zeros(
            (), dtype=torch.int64, device=dev)
    stats = TickStats(broadcast_msgs=g[0], reduce_msgs=g[1],
                      cross_part_msgs=g[2], emitted=g[3], dropped=g[4],
                      wire_rows=g[5], route_deferred=g[6],
                      route_dropped=g[7], n_suppressed=g[8],
                      occ_bc_defer=occ_bc, occ_rmi_defer=occ_rmi,
                      route_peak=route_peak, outbox_part_peak=outbox_pp,
                      busy=busy)
    return new_ls, outbox, stats, extra_out


def has_work(ls: LayerState):
    """Termination predicate (0-d bool tensor): any pending timer, unsent
    delta, or record still waiting in a routing defer ring (carried wire
    rows are in-flight work)."""
    return (ls.red_pending.any() | ls.fwd_pending.any()
            | ls.bc_defer_ok.any() | ls.rmi_defer_ok.any())
