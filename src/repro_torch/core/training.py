"""Stale-free distributed training, the halt-flush path (paper §4.3).

Counterpart of `repro/core/training.py`. Life-cycle (Fig. 3):
StartTraining majority vote -> halt -> flush in-flight events ->
full-batch layered backprop over the frozen graph -> Algorithm 3 model
averaging -> phased re-aggregation and update (phases 2/3) -> resume.

The layered backward (§4.3.2) re-uses the cached aggregator synopses and
features of the last forward pass; `backward_layer` is the training
plane's single-device routed backward (the oracle's gather path). The
coordinator is the online plane's exactness oracle: after a flush its
`_full_batch_grads` equal the online plane's quiescent gradients.

Algorithm 3: each logical part runs its LOCAL optimizer on its LOCAL
gradients over a leading [P] axis, then the parameters are averaged.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value

from repro_torch.core.delivery import KernelDelivery
from repro_torch.core.state import LayerState
from repro_torch.core.train_plane import (TrainConfig, backward_layer_routed,
                                          head_logits)
from repro_torch.dist.grad_compression import compress_decompress
from repro_torch.dist.router import LocalRouter
from repro_torch.optim.optimizers import init_stacked, tree_map


# --------------------------------------------------------------- forward
@torch.no_grad()
def rebuild_layer(layer, params, topo, feat, has_feat, delivery=None):
    """Phases 2+3 for one layer: batch reduce (one aggregate per master)
    + update + replica broadcast. Returns the next layer's (feat,
    has_feat) on the same [P, N] layout, plus the (agg, cnt) caches."""
    delivery = delivery or KernelDelivery()
    P, N, d = feat.shape
    dev = feat.device
    pp = torch.arange(P, device=dev)[:, None]
    feat_flat = feat.reshape(P * N, d)
    has_flat = has_feat.reshape(P * N)
    src = (pp * N + topo.e_src_slot).reshape(-1)
    live = topo.e_valid.reshape(-1) & has_flat[src]
    msg = layer.message_params(params, feat_flat[src])
    tgt = torch.where(live, (topo.e_dst_mpart * N
                             + topo.e_dst_mslot).reshape(-1), P * N)
    agg, cnt = delivery.add_rows(P * N, tgt, msg, live.to(torch.float32))
    mean = agg / torch.clamp(cnt, min=1.0)[:, None]
    x_next = layer.update_params(params, feat_flat, mean)
    ready = topo.is_master.reshape(P * N) & has_flat
    x_next = torch.where(ready[:, None], x_next, 0.0)
    # replica broadcast of the next layer's features
    r_midx = (pp * N + topo.r_master_slot).reshape(-1)
    r_live = topo.r_valid.reshape(-1) & ready[r_midx]
    r_tgt = torch.where(r_live, (topo.r_rep_part * N
                                 + topo.r_rep_slot).reshape(-1), P * N)
    x_b, touched = delivery.deliver_set(x_next, r_tgt, x_next[r_midx])
    has_next = ready | touched
    d_out = x_next.shape[-1]
    return (x_b.reshape(P, N, d_out), has_next.reshape(P, N),
            agg.reshape(P, N, -1), cnt.reshape(P, N))


# --------------------------------------------------------------- backward
def backward_layer(layer, params, topo, feat, agg, cnt, g_next,
                   delivery=None):
    """One layer of §4.3.2's two phases over all P parts on one device.

    feat [P, N, d_in] cached inputs; (agg, cnt) the cached synopsis;
    g_next [P, N, d_out] dL/dx^{l+1} at masters. Returns (per-part param
    grads [P, ...], g_prev [P, N, d_in] routed to source masters)."""
    return backward_layer_routed(
        layer, params, topo, feat, agg, cnt, g_next,
        LocalRouter(n_parts=feat.shape[0]), 0, delivery or KernelDelivery())


# ------------------------------------------------------------ coordinator
@dataclass
class TrainResult:
    losses: list
    votes: int
    flush_ticks: int


class MeshView:
    """A mesh pipeline's state in the reference's global layout, for the
    coordinator: JAX's coordinator computes on the sharded pipeline's
    global arrays, and here every rank gathers them
    (`ft/checkpoint.gather_tree`, collective over the mesh), runs the same
    arithmetic on them, and `commit` writes its own block of the rebuilt
    layers and sink back into the pipeline. The parameters are replicated,
    so each rank updates its own copy alike."""

    def __init__(self, pipe):
        from repro_torch.ft.checkpoint import (gather_tree, pipeline_tree,
                                               tree_unflatten)
        tree = tree_unflatten(pipeline_tree(pipe),
                              [leaf for _, leaf in gather_tree(pipe)])
        self.pipe = pipe
        self.topo, self.sink = tree["topo"], tree["sink"]
        self.sink_seen = tree["sink_seen"]
        S = pipe.n_stages
        # layer l = r * S + s is round r's state, stage s's slice on a grid
        self._states = [
            st if S == 1 else replace(st, **{
                f.name: getattr(st, f.name)[l % S] for f in fields(st)})
            for l in range(len(pipe.layers))
            for st in [tree["layers"][l // S]]]

    def __getattr__(self, name):      # cfg, part, device, layers, params...
        return getattr(self.pipe, name)

    def layer_state(self, l: int):
        return self._states[l]

    def set_layer_state(self, l: int, ls) -> None:
        self._states[l] = ls

    def commit(self) -> None:
        """This rank's block of the rebuilt features, caches and sink into
        the pipeline (window timers, sketches and defer rings stay)."""
        pipe, mesh = self.pipe, self.pipe.mesh
        P = self.pipe.cfg.n_parts // mesh.n_data
        lo = mesh.data_index * P
        block = lambda x: x[lo:lo + P]                       # noqa: E731
        for l in range(len(pipe.layers)):
            if l % pipe.n_stages != mesh.stage_index:
                continue
            st, new = pipe.layer_state(l), self._states[l]
            pipe.set_layer_state(l, replace(
                st, **{k: block(getattr(new, k)) for k in (
                    "feat", "has_feat", "x_sent", "has_sent", "agg",
                    "agg_cnt")},
                red_pending=torch.zeros_like(st.red_pending),
                fwd_pending=torch.zeros_like(st.fwd_pending)))
        pipe.sink, pipe.sink_seen = block(self.sink), block(self.sink_seen)


class TrainingCoordinator:
    """Majority-vote start, halt+flush, train, rebuild, resume (§4.3.1).

    On a mesh every rank calls `train` (it is collective): each computes
    on the gathered global state (`MeshView`), as JAX's one program does.
    head: the output operator (a Linear, e.g. GraphSAGE(...,
    n_classes=C).head); head_params its {"w", "b"} tree. Both paths
    consume the same validated TrainConfig."""

    def __init__(self, pipe, head, head_params, cfg: TrainConfig):
        if not isinstance(cfg, TrainConfig):
            raise TypeError(
                "TrainingCoordinator takes a TrainConfig (optimizer, lr, "
                "batch_threshold, epochs, compression) instead of loose "
                f"keyword arguments — got {type(cfg).__name__}")
        self.pipe = pipe
        self.head = head
        self.head_params = head_params
        self.cfg = cfg
        self.labels: dict = {}
        self._residuals, self._opt_states = {}, {}
        self._head_opt = None

    def observe_labels(self, labels: dict):
        self.labels.update(labels)

    def votes(self) -> int:
        """Output sub-operators vote StartTraining when their local batch
        reaches the threshold."""
        t = self.pipe.part.t
        per_part = np.zeros(self.pipe.cfg.n_parts, np.int64)
        for vid in self.labels:
            if t.master[vid] >= 0:
                per_part[t.master[vid]] += 1
        return int((per_part >= self.cfg.batch_threshold).sum())

    def should_train(self) -> bool:
        return self.votes() > self.pipe.cfg.n_parts // 2

    # ---------------------------------------------------------------- train
    def train(self, epochs: int | None = None) -> TrainResult:
        epochs = self.cfg.epochs if epochs is None else epochs
        flush_ticks = self.pipe.flush()            # stale-free guarantee
        view = self.pipe if self.pipe.mesh is None else MeshView(self.pipe)
        label_arr, label_mask = self._device_labels()
        losses = []
        for _ in range(epochs):
            loss, head_grads, part_grads = self._full_batch_grads(
                label_arr, label_mask, view)
            losses.append(float(loss))
            self._apply_alg3(head_grads, part_grads)
        self._rebuild(view)                        # phases 2 and 3
        if view is not self.pipe:
            view.commit()
        return TrainResult(losses=losses, votes=self.votes(),
                           flush_ticks=flush_ticks)

    def _device_labels(self):
        cfg = self.pipe.cfg
        t = self.pipe.part.t
        arr = np.zeros((cfg.n_parts, cfg.node_cap), np.int64)
        mask = np.zeros((cfg.n_parts, cfg.node_cap), bool)
        for vid, y in self.labels.items():
            p, s = t.master[vid], t.master_slot[vid]
            if p >= 0:
                arr[p, s] = y
                mask[p, s] = True
        dev = self.pipe.device
        return (torch.as_tensor(arr).to(dev), torch.as_tensor(mask).to(dev))

    def _full_batch_grads(self, label_arr, label_mask, pipe=None):
        """Loss + per-part grads via the layered backward (over `pipe`, the
        pipeline or its MeshView)."""
        pipe = pipe or self.pipe
        states = [pipe.layer_state(l) for l in range(len(pipe.layers))]
        mask = label_mask & pipe.sink_seen

        def head_loss(hp, x):
            logp = F.log_softmax(head_logits(self.head, hp, x)
                                 .to(torch.float32), dim=-1)
            gold = torch.take_along_dim(logp, label_arr[..., None],
                                        dim=-1)[..., 0]
            n = torch.clamp(torch.sum(mask), min=1)
            return torch.sum(torch.where(mask, -gold, 0.0)) / n

        (head_grads, g), loss = grad_and_value(head_loss, argnums=(0, 1))(
            self.head_params, pipe.sink)
        params = pipe.params
        part_grads = {}
        for li in reversed(range(len(pipe.layers))):
            ls = states[li]
            dparams, g = backward_layer(pipe.layers[li], params[f"l{li}"],
                                        pipe.topo, ls.feat, ls.agg,
                                        ls.agg_cnt, g, pipe.delivery)
            part_grads[f"l{li}"] = dparams
        return loss, head_grads, part_grads

    def _apply_alg3(self, head_grads, part_grads):
        """Algorithm 3: local optimizer per part, then the parameter mean;
        with cfg.compression the per-part gradients pass the
        error-feedback compressor first (host-carried residuals)."""
        pipe, opt, lr = self.pipe, self.cfg.optimizer, self.cfg.lr
        P = pipe.cfg.n_parts
        params = pipe.params
        for name, dparams in part_grads.items():
            if self.cfg.compression:
                res = self._residuals.get(name)
                if res is None:
                    res = tree_map(lambda g: torch.zeros(
                        g.shape, dtype=torch.float32, device=g.device),
                        dparams)
                dparams, self._residuals[name] = compress_decompress(
                    dparams, res, int8=self.cfg.int8,
                    topk_frac=self.cfg.topk_frac, batched=True)
            base = params[name]
            if name not in self._opt_states:
                self._opt_states[name] = init_stacked(opt, base, P)
            stacked = tree_map(lambda p: p.expand((P,) + tuple(p.shape)),
                               base)
            upd, self._opt_states[name] = opt.update(
                self._opt_states[name], dparams, stacked, lr)
            pipe.layers[int(name[1:])].load_param_tree(tree_map(
                lambda p, u: torch.mean(p + u, 0), stacked, upd))
        if self._head_opt is None:
            self._head_opt = opt.init(self.head_params)
        upd, self._head_opt = opt.update(self._head_opt, head_grads,
                                         self.head_params, lr)
        self.head_params = tree_map(lambda a, b: a + b, self.head_params,
                                    upd)

    def _rebuild(self, pipe=None):
        """Phases 2+3: layer-by-layer re-aggregation and update with the
        refreshed model; refreshes the engine caches and the sink (of
        `pipe`, the pipeline or its MeshView)."""
        pipe = pipe or self.pipe
        feat = pipe.layer_state(0).feat
        has = pipe.layer_state(0).has_feat
        params = pipe.params
        for li, layer in enumerate(pipe.layers):
            nf, nh, agg, cnt = rebuild_layer(layer, params[f"l{li}"],
                                             pipe.topo, feat, has,
                                             pipe.delivery)
            st = pipe.layer_state(li)
            pipe.set_layer_state(li, LayerState(
                feat=feat, has_feat=has, x_sent=feat, has_sent=has,
                agg=agg, agg_cnt=cnt,
                red_pending=torch.zeros_like(st.red_pending),
                red_deadline=st.red_deadline,
                fwd_pending=torch.zeros_like(st.fwd_pending),
                fwd_deadline=st.fwd_deadline, cms=st.cms,
                last_touch=st.last_touch,
                bc_defer=st.bc_defer, bc_defer_ok=st.bc_defer_ok,
                rmi_defer=st.rmi_defer, rmi_defer_ok=st.rmi_defer_ok))
            feat, has = nf, nh
        # masters' final embeddings -> sink
        is_m = pipe.topo.is_master
        pipe.sink = torch.where((is_m & has)[..., None], feat, pipe.sink)
        pipe.sink_seen = pipe.sink_seen | (is_m & has)
