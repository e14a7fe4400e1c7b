"""The TRAINING plane: windowed online learning inside the tick (§4.3).

Counterpart of `repro/core/train_plane.py`. Every tick of a pipeline built
with `train=TrainConfig(...)` (and PipelineConfig.train_cap > 0) ends with
`train_stage`, which

  1. ingests the tick's LabelBatch at master coordinates;
  2. forms the sliding-window batch: masters labeled AND materialized in
     the sink AND touched within the last `TrainConfig.window` ticks
     (window 0: no recency gate);
  3. runs the layered backward of §4.3.2 through the LIVE state — on one
     device the halt-flush oracle's gather path, on the mesh with the two
     cross-part hops (master -> replica dagg, replica -> master source
     gradients) as dense `route_lanes` lanes;
  4. optionally error-feedback-compresses the per-part gradients
     (`dist/grad_compression.py`, residual carried in TrainState);
  5. applies Algorithm 3 (one optimizer per part over the leading [P]
     axis, then the global parameter mean) only where the batch FIRES
     (global active count >= `batch_threshold`).

The backward runs every tick; `fire` only masks the application through
`torch.where`, so the plane adds no host branch and no host read: the
super-tick driver still syncs once a super-tick. The three scatters of
the backward (the edge fold, the replica fold, the replica zeroing) go
through the delivery plane, so on the "kernel" backend they are kernel A,
deterministic where CUDA's index_add_ is not.

The plane adds no pending work: a fire consumes (clears) the dirty set,
and a tick that still moved messages re-dirties every labeled and seen
master, so a flush fires once more on exactly the quiescent fixed point
and later quiet ticks have an empty batch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vjp, vmap

from repro_torch.core.events import MsgBatch
from repro_torch.core.state import local_index, mark_rows, scatter_set
from repro_torch.dist.grad_compression import compress_decompress
from repro_torch.dist.router import MeshRouter
from repro_torch.dist.wire import init_defer
from repro_torch.optim.optimizers import (Optimizer, init_stacked,
                                          tree_leaves, tree_map)


# ----------------------------------------------------------------- config
@dataclass(frozen=True)
class TrainConfig:
    """Validated training knobs, shared by the halt-flush coordinator
    (`core/training.py`) and the online plane, as in JAX:

      optimizer       : a `repro_torch.optim` Optimizer.
      lr              : step size.
      batch_threshold : coordinator — per-part label count for a
                        StartTraining vote; online — GLOBAL active-batch
                        size at which a tick's step fires.
      epochs          : coordinator passes per train() call (the online
                        plane takes one step per firing tick).
      window          : online recency window in ticks (0 = no gate).
      compression     : per-part gradients through the error-feedback
                        compressor before Algorithm 3.
      int8, topk_frac : compressor parameters.
    """
    optimizer: Optimizer
    lr: float = 1e-2
    batch_threshold: int = 8
    epochs: int = 1
    window: int = 0
    compression: bool = False
    int8: bool = True
    topk_frac: float = 0.25

    def __post_init__(self):
        if not isinstance(self.optimizer, Optimizer):
            raise ValueError(
                f"optimizer must be a repro_torch.optim Optimizer, got "
                f"{type(self.optimizer).__name__}")
        if self.batch_threshold < 1:
            raise ValueError(
                f"batch_threshold={self.batch_threshold} must be >= 1")
        if self.epochs < 1:
            raise ValueError(f"epochs={self.epochs} must be >= 1")
        if self.window < 0:
            raise ValueError(f"window={self.window} must be >= 0 "
                             "(0 disables the recency gate)")
        if not (self.lr >= 0.0):
            raise ValueError(f"lr={self.lr} must be finite and >= 0")
        if not (0.0 < self.topk_frac <= 1.0):
            raise ValueError(
                f"topk_frac={self.topk_frac} must be in (0, 1]")


# ------------------------------------------------------------------ state
@dataclass(frozen=True)
class TrainState:
    """Device-side training-plane state over the rank's [P, N] block."""
    labels: torch.Tensor     # [P, N] int64 gold class per master slot
    label_mask: torch.Tensor  # [P, N] bool slot carries a label
    dirty: torch.Tensor      # [P, N] bool labeled master awaiting a step
    touch: torch.Tensor      # [P, N] int64 last tick the sink row moved
    params: dict             # {f"l{i}": tree} live layer params
    head_params: dict        # head tree {"w", "b"}
    opt: dict                # {f"l{i}": per-part state [P, ...], "head"}
    residual: dict           # {f"l{i}": [P, ...] f32} error feedback
                             # (empty when compression is off)
    last_grad: dict          # {f"l{i}": tree, "head": tree} GLOBAL summed
                             # grads of the last fired step
    loss: torch.Tensor       # f32 0-d, last fired step
    grad_norm: torch.Tensor  # f32 0-d, last fired step
    steps: torch.Tensor      # int64 0-d, fired steps so far


def _clone(tree):
    return tree_map(lambda p: p.detach().clone(), tree)


def init_train_state(n_parts: int, node_cap: int, layer_params: dict,
                     head_params: dict, tcfg: TrainConfig,
                     device) -> TrainState:
    """Fresh training-plane state for `n_parts` parts (the rank's block);
    per-part optimizer state for the layers, one plain state for the
    head."""
    P, N = n_parts, node_cap
    params = {k: _clone(v) for k, v in layer_params.items()}
    head = _clone(head_params)
    opt = {k: init_stacked(tcfg.optimizer, v, P) for k, v in params.items()}
    opt["head"] = tcfg.optimizer.init(head)
    residual = {}
    if tcfg.compression:
        residual = {k: tree_map(lambda p: torch.zeros(
            (P,) + tuple(p.shape), dtype=torch.float32, device=p.device), v)
            for k, v in params.items()}
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    last_grad = {k: tree_map(zeros, v) for k, v in params.items()}
    last_grad["head"] = tree_map(zeros, head)
    z = lambda dt: torch.zeros((P, N), dtype=dt, device=device)
    f0 = torch.zeros((), dtype=torch.float32, device=device)
    return TrainState(
        labels=z(torch.int64), label_mask=z(torch.bool),
        dirty=z(torch.bool), touch=z(torch.int64), params=params,
        head_params=head, opt=opt, residual=residual, last_grad=last_grad,
        loss=f0, grad_norm=f0.clone(),
        steps=torch.zeros((), dtype=torch.int64, device=device))


# --------------------------------------------------------------- backward
def _dense(router):
    """Gradient lanes never defer or drop: they ride the dense exchange
    whatever the data plane's route_cap (and report no telemetry peak)."""
    if isinstance(router, MeshRouter) and (router.route_cap is not None
                                           or router.telemetry):
        return dataclasses.replace(router, route_cap=None, telemetry=False)
    return router


def backward_layer_routed(layer, params, topo, feat, agg, cnt, g_next,
                          router, part0, delivery):
    """One layer of §4.3.2 on the LOCAL block of parts.

    The per-part VJP of psi (`layer.update_params`) gives the per-part
    parameter grads, the self-path input grad and dL/dmean; dL/dagg =
    dL/dmean / max(cnt, 1). Each edge takes its destination's dagg, the
    VJP of phi carries it to the edge's source row, and replica rows fold
    onto their masters.

    One device (`router.n_devices == 1`): the halt-flush oracle's gather
    path. On the mesh: hop A ships dagg from masters to every replica over
    the replication records, so each edge gathers it at its LOCAL
    destination slot, and hop B folds replica-row accumulations onto the
    master coordinates (TopoState's m_part/m_slot mirror). Both hops ride
    `route_lanes` as dense lanes of width d + 5.

    Returns (per-part param grads [P_loc, ...], g_prev [P_loc, N, d_in]).
    """
    Pl, N, d_in = feat.shape
    dev = feat.device
    PN = Pl * N
    pp = torch.arange(Pl, device=dev)[:, None]
    feat_flat = feat.reshape(PN, d_in)
    cnt_flat = cnt.reshape(PN)
    den = torch.clamp(cnt_flat, min=1.0)[:, None]
    mean = agg.reshape(PN, -1) / den

    def per_part(x_p, a_p, g_p):
        _, f = vjp(lambda q, x, a: layer.update_params(q, x, a),
                   params, x_p, a_p)
        return f(g_p)

    dparams, dx_self, dmean = vmap(per_part)(
        feat, mean.reshape(Pl, N, -1), g_next.reshape(Pl, N, -1))
    dx_self = dx_self.reshape(PN, d_in)
    dagg = dmean.reshape(PN, -1) / den
    d_agg = dagg.shape[-1]
    is_m = topo.is_master.reshape(PN)
    src = (pp * N + topo.e_src_slot).reshape(-1)
    live = topo.e_valid.reshape(-1)
    sentinel = torch.full_like(src, PN)

    def phi_vjp(x_e, g_e):
        _, f = vjp(lambda x: layer.message_params(params, x), x_e)
        return f(g_e)[0]

    def edge_fold(dagg_at_dst):
        """Per-edge message grads at the edges' sources, summed per source
        row (kernel A: live edges only, in edge order)."""
        dx_src = phi_vjp(feat_flat[src], dagg_at_dst)
        return delivery.add_rows(PN, torch.where(live, src, sentinel),
                                 dx_src)[0]

    if router.n_devices == 1:
        tgt = (topo.e_dst_mpart * N + topo.e_dst_mslot).reshape(-1)
        g_prev = edge_fold(torch.where(live[:, None], dagg[tgt], 0.0))
        # replica -> master fold, then the replica rows are zeroed
        r_midx = (pp * N + topo.r_master_slot).reshape(-1)
        r_tgt = (topo.r_rep_part * N + topo.r_rep_slot).reshape(-1)
        r_live = topo.r_valid.reshape(-1)
        r_none = torch.full_like(r_tgt, PN)
        fold = torch.where(r_live[:, None], g_prev[r_tgt], 0.0)
        g_prev, _, _ = delivery.deliver_add(
            g_prev, None, torch.where(r_live, r_midx, r_none), fold, None)
        g_prev, _ = delivery.deliver_set(
            g_prev, torch.where(r_live, r_tgt, r_none),
            g_prev.new_zeros((1, d_in)).expand(r_tgt.shape[0], d_in))
        g_prev = g_prev + torch.where(is_m[:, None], dx_self, 0.0)
        return dparams, g_prev.reshape(Pl, N, d_in)

    droute = _dense(router)
    Rc = topo.r_master_slot.shape[1]
    # hop A: master dagg -> replica rows (one row per replication record)
    r_src = (pp * N + topo.r_master_slot).reshape(-1)
    ha = MsgBatch(
        part=topo.r_rep_part.reshape(-1), slot=topo.r_rep_slot.reshape(-1),
        vec=dagg[r_src], cnt=torch.zeros(Pl * Rc, device=dev),
        src_part=(part0 + pp).expand(Pl, Rc).reshape(-1),
        valid=topo.r_valid.reshape(-1))
    (da,), _, _ = droute.route_lanes((ha,), (init_defer(0, d_agg + 5, dev),))
    ia, _ = local_index(da.part, da.slot, part0, Pl, N, da.valid)
    dagg_rep, _ = delivery.deliver_set(dagg.new_zeros((PN, d_agg)), ia,
                                       da.vec)
    dagg_t = torch.where(is_m[:, None], dagg, dagg_rep)
    # per-edge message grads gather at the edge's LOCAL destination slot
    dst = (pp * N + topo.e_dst_slot).reshape(-1)
    g_loc = edge_fold(torch.where(live[:, None], dagg_t[dst], 0.0))
    g_loc = g_loc + torch.where(is_m[:, None], dx_self, 0.0)
    # hop B: replica-row accumulations -> master coordinates
    hb_valid = (topo.v_exists.reshape(-1) & ~is_m
                & (topo.m_part.reshape(-1) >= 0))
    hb = MsgBatch(
        part=topo.m_part.reshape(-1), slot=topo.m_slot.reshape(-1),
        vec=g_loc, cnt=torch.zeros(PN, device=dev),
        src_part=(part0 + pp).expand(Pl, N).reshape(-1), valid=hb_valid)
    (db,), _, _ = droute.route_lanes((hb,), (init_defer(0, d_in + 5, dev),))
    ib, _ = local_index(db.part, db.slot, part0, Pl, N, db.valid)
    g_prev, _, _ = delivery.deliver_add(
        torch.where(is_m[:, None], g_loc, 0.0), None, ib, db.vec, None)
    return dparams, g_prev.reshape(Pl, N, d_in)


def _psum_tree(router, tree):
    """router.psum of every leaf of a float tree in ONE collective on the
    mesh (the identity under the LocalRouter)."""
    if router.n_devices == 1:
        return tree
    leaves = tree_leaves(tree)
    flat = router.psum(torch.cat([x.reshape(-1) for x in leaves]))
    out, off = [], 0
    for x in leaves:
        out.append(flat[off:off + x.numel()].reshape(x.shape))
        off += x.numel()
    it = iter(out)
    return _rebuild(tree, it)


def _rebuild(tree, it):
    """A tree like `tree` whose leaves come from `it` in tree_leaves
    order."""
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    return next(it)


# ------------------------------------------------------------ train stage
def head_logits(head, hp, x):
    """The output operator over a parameter tree (a Linear head)."""
    return functional_call(head, hp, (x,))


def train_stage(tcfg: TrainConfig, head, layers_bw, layer_feats, topo,
                sink, sink_seen, ts: TrainState, lb, sink_fb, now, moved,
                router, part0, delivery) -> TrainState:
    """The fifth plane: one windowed online step at the end of a tick.

    layers_bw   : per layer (layer, its live params tree[, take_p]):
                  take_p picks the "p" sub-tree of the param grads (the
                  2-D pipeline wraps params as {"p": ..., "act": ...}).
    layer_feats : per layer (feat, agg, agg_cnt) caches of the local block.
    lb          : the tick's LabelBatch (vids unique within it).
    sink_fb     : the tick's final feature batch (rows whose sink entry
                  moved: their masters' recency `touch` refreshes).
    now         : 0-d int64 tick; moved: 0-d int64, GLOBAL messages moved
                  this tick (0 at the quiescent fixed point).
    """
    Pl, N = ts.labels.shape
    flat = Pl * N
    dev = ts.labels.device

    # (1) label ingest at master coordinates
    il, _ = local_index(lb.part, lb.slot, part0, Pl, N, lb.valid)
    hit = mark_rows(flat, il, dev)
    labels = scatter_set(ts.labels.reshape(flat), il, lb.label)
    lmask = ts.label_mask.reshape(flat) | hit
    dirty = ts.dirty.reshape(flat) | hit
    touch = torch.where(hit, now, ts.touch.reshape(flat))

    # (2) recency refresh from this tick's sink updates
    it, _ = local_index(sink_fb.part, sink_fb.slot, part0, Pl, N,
                        sink_fb.valid)
    touch = torch.where(mark_rows(flat, it, dev), now, touch)
    labels, lmask = labels.reshape(Pl, N), lmask.reshape(Pl, N)
    dirty, touch = dirty.reshape(Pl, N), touch.reshape(Pl, N)

    # (3) sliding-window batch formation + the global fire vote
    active = dirty & lmask & sink_seen
    if tcfg.window > 0:
        active = active & ((now - touch) <= tcfg.window)
    n_active = router.psum(active.sum())
    fire = n_active >= tcfg.batch_threshold
    n1 = torch.clamp(n_active.to(torch.float32), min=1.0)

    # (4) output operator: masked-mean CE over the global active batch
    def local_loss(hp, x):
        logp = F.log_softmax(head_logits(head, hp, x).to(torch.float32),
                             dim=-1)
        gold = torch.take_along_dim(logp, labels[..., None], dim=-1)[..., 0]
        return torch.sum(torch.where(active, -gold, 0.0)) / n1

    (d_hp, g), lsum = grad_and_value(local_loss, argnums=(0, 1))(
        ts.head_params, sink)

    # (5) layered backward through the live caches
    part_grads, local = {}, {}
    for li in reversed(range(len(layers_bw))):
        layer, lp, *take_p = layers_bw[li]
        feat, agg, cntv = layer_feats[li]
        dparams, g = backward_layer_routed(layer, lp, topo, feat, agg,
                                           cntv, g, router, part0, delivery)
        if take_p and take_p[0]:
            dparams = dparams["p"]
        part_grads[f"l{li}"] = dparams
        local[f"l{li}"] = tree_map(lambda a: torch.sum(a, 0), dparams)
    summed = _psum_tree(router, {"loss": lsum, "head": d_hp, **local})
    loss = summed.pop("loss")
    head_grad = summed["head"]
    glob = summed

    # (6) diagnostics
    grad_norm = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                               for x in tree_leaves(glob)))

    # (7) Algorithm 3, fire-masked: per-part optimizer, global mean update
    keep = lambda a, b: torch.where(fire, a, b)
    new_params, new_opt, new_res, upds = {}, {}, {}, {}
    for name, gpart in part_grads.items():
        if tcfg.compression:
            res = ts.residual[name]
            gpart, res2 = compress_decompress(
                gpart, res, int8=tcfg.int8, topk_frac=tcfg.topk_frac,
                batched=True)
            new_res[name] = tree_map(keep, res2, res)
        stacked = tree_map(lambda p: p.expand((Pl,) + tuple(p.shape)),
                           ts.params[name])
        upd, s_new = tcfg.optimizer.update(ts.opt[name], gpart, stacked,
                                           tcfg.lr)
        upds[name] = tree_map(lambda u: torch.sum(u, 0), upd)
        new_opt[name] = tree_map(keep, s_new, ts.opt[name])
    upds = _psum_tree(router, upds)
    inv_p = 1.0 / router.n_parts
    for name, delta in upds.items():
        new_params[name] = tree_map(
            lambda p, d: torch.where(fire, p + (d * inv_p).to(p.dtype), p),
            ts.params[name], delta)
    upd_h, hs = tcfg.optimizer.update(ts.opt["head"], head_grad,
                                      ts.head_params, tcfg.lr)
    new_head = tree_map(lambda p, u: torch.where(fire, p + u.to(p.dtype), p),
                        ts.head_params, upd_h)
    new_opt["head"] = tree_map(keep, hs, ts.opt["head"])

    # (8) batch bookkeeping: a fire consumes the batch; a moving stream
    # re-dirties AFTER the consume, so the final flush fire lands exactly
    # once, on the quiescent fixed point
    dirty = torch.where(fire, dirty & ~active, dirty)
    dirty = dirty | (lmask & sink_seen & (moved > 0))

    # (9) assemble (diagnostics latch on fire only)
    last_grad = tree_map(lambda a, b: keep(a.to(torch.float32), b), glob,
                         ts.last_grad)
    return TrainState(
        labels=labels, label_mask=lmask, dirty=dirty, touch=touch,
        params=new_params, head_params=new_head, opt=new_opt,
        residual=new_res, last_grad=last_grad, loss=keep(loss, ts.loss),
        grad_norm=keep(grad_norm, ts.grad_norm),
        steps=ts.steps + fire.to(torch.int64))
