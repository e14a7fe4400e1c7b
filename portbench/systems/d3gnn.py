"""The D3-GNN streaming engine of `repro_torch` as the system under test.

A run builds one `D3Pipeline` from the configuration, warms it with the
mix's first launches (serving: then a drain, which gives each vertex that
the reads name its embedding), then drives it back to back for the
window: through `ServeSession.advance_super` with open-loop point reads beside the stream
when the configuration turns the query plane on, through
`D3Pipeline.run_super_tick` with label chunks when it turns the training
plane on. What the comparison reads is taken from the same pipeline:

  * serving: after the window, consistent reads drawn from the seed and a
    drain flush; then both layers' embeddings of every ingested vertex and
    the consistent answers;
  * training: in set-up, after the warm launches and a drain flush, both
    layers' embeddings, then three launches whose first tick carries
    distinct labels, each firing one step: each step's loss, the first
    step's gradients as the optimizer got them (its Adam state) and the
    parameters after the three; after the window and a drain flush, what
    the window's ingest left at every ingested vertex's master that the
    trained weights do not touch: layer 0's input row and in-neighbour
    sum, and each layer's in-edge count.

The plain reference (`portbench/reference/<name>.py`) works all of it out
again from the benchmark's own inputs after the window.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench import compare
from portbench.traffic.generator import WEIGHTS, Traffic, torch_seed


def draw_weights(dims, n_classes, seed, device) -> dict:
    """Every weight in one draw on the device: w ~ N(0, 1 / fan_in),
    biases ~ N(0, 0.01^2); {l{i}: {self: {w, b}, neigh: {w}}, head}."""
    shapes = []
    for i in range(len(dims) - 1):
        shapes += [(f"l{i}", "self", "w", (dims[i], dims[i + 1])),
                   (f"l{i}", "self", "b", (dims[i + 1],)),
                   (f"l{i}", "neigh", "w", (dims[i], dims[i + 1]))]
    if n_classes:
        shapes += [("head", None, "w", (dims[-1], n_classes)),
                   ("head", None, "b", (n_classes,))]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed,
                                                                WEIGHTS))
    flat = torch.randn(sum(int(np.prod(s)) for *_, s in shapes),
                       generator=gen, device=device)
    out, at = {}, 0
    for top, sub, leaf, shape in shapes:
        n = int(np.prod(shape))
        x = flat[at:at + n].reshape(shape)
        at += n
        x = x * (0.01 if leaf == "b" else shape[0] ** -0.5)
        node = out.setdefault(top, {})
        (node.setdefault(sub, {}) if sub else node)[leaf] = x.contiguous()
    return out


class Run:
    """One run of one cell: set-up, window, the program's outputs, the
    reference's comparison."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 control: str | None = None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.T = int(mix["super_ticks"])
        self.dims = [cfg["d_in"]] + [cfg["d_hid"]] * cfg["n_layers"]
        self.train = cfg.get("train")
        self.serve = cfg.get("query_cap", 0) > 0
        self.got = {}          # the program's outputs the check reads

    # ------------------------------------------------------------ set-up
    def setup(self):
        from repro_torch.core import windowing as win
        from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
        from repro_torch.core.train_plane import TrainConfig
        from repro_torch.graph.sage import GraphSAGE, load_linear_tree
        from repro_torch.optim import adam
        from repro_torch.serve.session import ServeSession
        cfg, dev = self.cfg, self.device
        n_classes = self.train["n_classes"] if self.train else 0
        self.traffic = Traffic(self.mix, cfg["n_vertices"], cfg["d_in"],
                               self.seed, dev, n_classes)
        self.weights = draw_weights(self.dims, n_classes, self.seed, dev)
        model = GraphSAGE(self.dims, seed=0, n_classes=n_classes).to(dev)
        for i, layer in enumerate(model.layers):
            layer.load_param_tree(self.weights[f"l{i}"])
        if n_classes:
            load_linear_tree(model.head, self.weights["head"])
        pcfg = PipelineConfig(
            n_parts=cfg["n_parts"], node_cap=cfg["node_cap"],
            edge_cap=cfg["edge_cap"], repl_cap=cfg["repl_cap"],
            feat_cap=cfg["feat_cap"], edge_tick_cap=cfg["edge_tick_cap"],
            query_cap=cfg.get("query_cap", 0),
            query_tick_cap=cfg.get("query_tick_cap"),
            train_cap=self.train["train_cap"] if self.train else 0,
            window=win.WindowConfig(kind=cfg["window"]["kind"],
                                    interval=cfg["window"]["interval"]),
            delta_eps=cfg["delta_eps"],
            delivery_backend=cfg["delivery_backend"],
            partitioner=cfg["partitioner"], max_nodes=cfg["n_vertices"])
        tcfg = None
        if self.train:
            t = self.train
            tcfg = TrainConfig(
                optimizer=adam(), lr=t["lr"],
                batch_threshold=t["batch_threshold"], window=t["window"],
                compression=t["compression"], int8=t["int8"],
                topk_frac=t["topk_frac"])
        self.pipe = D3Pipeline(model, pcfg, train=tcfg, device=dev)
        self.sess = (ServeSession(self.pipe, driver="super",
                                  super_ticks=self.T, max_retained=2 ** 40)
                     if self.serve else None)
        for i in range(int(self.mix["warm_super_ticks"])):
            e, f = self.traffic.next_launch()
            if self.serve:
                # reads of the first tick's vertices warm the query plane
                vids = np.unique(e[0].reshape(-1))[:64]
                self.sess.submit_embed(vids)
                self.sess.submit_link(np.stack([vids, vids[::-1]], 1))
                self.sess.advance_super(e, f, T=self.T)
                self.sess.answers.clear()
            else:
                self.pipe.run_super_tick(e, f, T=self.T)
        if self.serve:
            # every vertex the window's reads name gets its embedding
            self.sess.flush(max_ticks=64 * self.T)
            self.sess.answers.clear()
        if self.train:
            self._train_steps()
            self._fired0 = self.pipe.train_stats()["steps"]
        _sync(dev)

    def _train_steps(self):
        """Drain, read both layers' embeddings, then fire the three
        checked steps through the window's own call."""
        pipe, T = self.pipe, self.T
        pipe.flush_super(max_ticks=64 * T, T=T)
        self.got["edges"] = self.traffic.all_edges()
        self.got.update(self._embeddings())
        chk = self.mix["check"]
        n, k = int(chk["train_steps"]), int(chk["labels_per_step"])
        vids = self.traffic.check_rng().choice(self.traffic.ingested(),
                                               n * k, replace=False)
        cls = self.traffic.classes
        self.got["steps"] = [vids[i * k:(i + 1) * k] for i in range(n)]
        losses, fired = [], []
        for i, rows in enumerate(self.got["steps"]):
            pipe.run_super_tick(T=T, label_chunks=[
                [(int(v), int(cls[v])) for v in rows]])
            st = pipe.train_stats()
            losses.append(st["loss"])
            fired.append(st["steps"])
            if i == 0:
                self.got["sent1"] = self._optimizer_grads()
        self.got["loss"], self.got["fired"] = losses, fired
        self.got["params"] = _to_host(_tree(pipe.train_state))
        self.got["last_grad"] = _to_host(pipe.train_state.last_grad)
        t = self.pipe.part.t
        self.got["master_part"] = t.master.copy()

    def _optimizer_grads(self):
        """The first step's gradients as the optimizer got them, from its
        Adam state: m / (1 - b1) (b1 = 0.9, the program's adam())."""
        opt = self.pipe.train_state.opt
        tree = {k: v["m"] for k, v in opt.items()}
        return _to_host(_map(lambda m: m / (1 - 0.9), tree))

    def _masters(self, vids):
        """(master part, master slot, has a master) of `vids` on the
        device; a vertex without a master reads slot (0, 0)."""
        t = self.pipe.part.t
        mp = torch.as_tensor(t.master[vids].astype(np.int64)).to(self.device)
        ms = torch.as_tensor(t.master_slot[vids].astype(np.int64)).to(
            self.device)
        ok = mp >= 0
        return torch.where(ok, mp, 0), torch.where(ok, ms, 0), ok

    def _embeddings(self):
        """Both layers' outputs at every ingested vertex's master: layer
        0's as layer 1's input cache, layer 1's from the sink."""
        pipe = self.pipe
        vids = self.traffic.ingested()
        mp, ms, ok = self._masters(vids)
        h = [pipe.states[l + 1].feat[mp, ms] for l in range(len(pipe.states)
                                                               - 1)]
        h.append(pipe.sink[mp, ms])
        seen = pipe.sink_seen[mp, ms] & ok
        return {"vids": vids, "h": [x.cpu() for x in h],
                "seen": seen.cpu().numpy()}

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer=None) -> dict:
        """Launches back to back: each launch starts with the reads due by
        then (serving) or the tick's labels (training); the window closes
        when the first launch that starts at or after `seconds` returns.
        The tracer's own time (profiler start and stop) is left out of
        the window's clock: of its seconds, of the read schedule and of
        each read's latency. Returns the run's counts."""
        tr, T, pipe = self.traffic, self.T, self.pipe
        per_tick = self.mix["labels"]["per_tick"] if self.train else 0
        if self.serve:
            due, is_link, uni = tr.query_schedule(seconds)
            self._pending = {}            # qid -> due time (self._clock)
            self._lat, self._answered, nq = [], 0, 0   # ok answers' latency
            dropped0 = pipe.metrics.queries_dropped
        host0 = pipe.metrics.host_seconds
        emitted = np.zeros(len(self.dims) - 1, np.int64)
        launches = events = 0
        self._aside, walls = 0.0, []
        t0 = self._clock()
        t_stop = t0 + seconds
        while True:
            t = self._clock()
            if tracer:
                self._set_aside(tracer.before, launches)
            with record_function("portbench:traffic"):
                if self.serve:
                    hi = int(np.searchsorted(due, min(t, t_stop) - t0,
                                             "right"))
                    if hi > nq:
                        self._submit(nq, hi, t0, due, is_link, uni)
                        nq = hi
                labels = tr.labels_for_launch(per_tick) if per_tick else None
                e, f = tr.next_launch()
            if self.serve:
                stats, _ = self.sess.advance_super(e, f, T=T)
            else:
                stats, _ = pipe.run_super_tick(e, f, T=T,
                                               label_chunks=labels)
            t_ret = self._clock()
            walls.append(t_ret - t)
            if tracer:
                self._set_aside(tracer.after, launches)
            launches += 1
            events += sum(len(c) for c in e) + sum(
                len(c) for c in labels or [])
            emitted += [int(s.emitted) for s in stats]
            if self.serve:
                self._harvest(t_ret)
            if t >= t_stop:
                break
        out = {"window_s": t_ret - t0, "launch_s": walls,
               "launches": launches,
               "ticks": launches * T, "events": events,
               "emitted": emitted.tolist(),
               "host_s": pipe.metrics.host_seconds - host0}
        if self.serve:
            out.update(queries_due=len(due),
                       dropped=pipe.metrics.queries_dropped - dropped0)
        return out

    def after_window(self, counts: dict, wait_s: float = 60.0):
        """Past the window's close: reads still queued are answered by
        launches without stream events, for up to `wait_s` (late, each
        timed from its due time); the training plane's fired steps."""
        if self.serve:
            t_end = self._clock() + wait_s
            while self._pending and self._clock() < t_end:
                self.sess.advance_super(T=self.T)
                self._harvest(self._clock())
            counts.update(answered=self._answered, ok=len(self._lat),
                          unanswered=len(self._pending))
            counts["latency_s"] = compare.tail_population(
                self._lat, counts["queries_due"])
        if self.train:
            counts["fired"] = self.pipe.train_stats()["steps"] - self._fired0

    def _clock(self) -> float:
        """The window's clock: the host's, less the tracer's time."""
        return time.perf_counter() - self._aside

    def _set_aside(self, fn, *args):
        t = time.perf_counter()
        fn(*args)
        self._aside += time.perf_counter() - t

    def _harvest(self, t_ret):
        """Answers back by `t_ret`: an ok one's latency from its due time;
        one that is not ok (never materialised, unknown, dropped at
        admission) counts only as answered."""
        answers = self.sess.answers
        for qid in [q for q in self._pending if q in answers]:
            due = self._pending.pop(qid)
            self._answered += 1
            if answers.pop(qid).ok:
                self._lat.append(t_ret - due)

    def _submit(self, lo, hi, t0, due, is_link, uni):
        tr, sess = self.traffic, self.sess
        idx = np.arange(lo, hi)
        emb, lnk = idx[~is_link[lo:hi]], idx[is_link[lo:hi]]
        if len(emb):
            qids = sess.submit_embed(tr.pick(uni[emb, 0]))
            self._pending.update(zip(qids, (t0 + due[emb]).tolist()))
        if len(lnk):
            pairs = np.stack([tr.pick(uni[lnk, 0]), tr.pick(uni[lnk, 1])],
                             1)
            qids = sess.submit_link(pairs)
            self._pending.update(zip(qids, (t0 + due[lnk]).tolist()))

    # ------------------------------------------------------------ tracing
    def span_targets(self):
        """(owner, attribute, span name) of the program's layer entries."""
        from repro_torch.core import events, partitioner, pipeline
        from repro_torch.serve import session
        return [(session.ServeSession, "advance_super",
                 "ServeSession.advance_super"),
                (pipeline.D3Pipeline, "run_super_tick",
                 "D3Pipeline.run_super_tick"),
                (partitioner.StreamingPartitioner, "ingest_edges",
                 "StreamingPartitioner.ingest_edges"),
                (events, "stack_batches", "events.stack_batches")]

    def kernel_entries(self):
        """(module, attribute) of the kernel entries of kernels 1 and 2."""
        from repro_torch.kernels.segment_reduce import ops
        return {"deliver_rows": (ops, "deliver_rows"),
                "mean_rows_gather": (ops, "mean_rows_gather")}

    def train_site_profile(self):
        """One more launch of the window's traffic under torch.profiler
        with stacks: (device ms under the training plane's call sites,
        device ms of all call sites)."""
        if not self.train or self.device.type != "cuda":
            return None
        from torch.profiler import ProfilerActivity, profile
        from portbench.yardstick.callsite import device_ms_by_site
        tr = self.traffic
        labels = tr.labels_for_launch(self.mix["labels"]["per_tick"])
        e, f = tr.next_launch()
        _sync(self.device)
        verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], with_stack=True,
                     experimental_config=verbose) as prof:
            self.pipe.run_super_tick(e, f, T=self.T, label_chunks=labels)
            _sync(self.device)
        by_site, _, _ = device_ms_by_site(prof)
        train = sum(ms for s, ms in by_site.items()
                    if s.startswith(("core/train_plane.py", "optim/")))
        return train, sum(by_site.values())

    # ------------------------------------------------------------ outputs
    def collect(self):
        """After the window: the serving check's consistent reads and
        drain, both layers' embeddings; then the program's state goes."""
        if self.serve:
            sess, T = self.sess, self.T
            rng = self.traffic.check_rng()
            chk = self.mix["check"]
            ne, nl = int(chk["consistent_embed"]), int(chk["consistent_link"])
            vids = self.traffic.pick(rng.uniform(size=ne))
            pairs = np.stack([self.traffic.pick(rng.uniform(size=nl))
                              for _ in range(2)], 1)
            qe = sess.submit_embed(vids, consistent=True)
            ql = sess.submit_link(pairs, consistent=True)
            sess.flush(max_ticks=64 * T)
            for _ in range(8):
                if all(q in sess.answers for q in qe + ql):
                    break
                sess.advance_super(T=T)
            ans = sess.answers
            self.got["embed"] = [(int(v), ans.get(q)) for v, q in
                                 zip(vids, qe)]
            self.got["link"] = [((int(u), int(v)), ans.get(q)) for (u, v), q
                                in zip(pairs, ql)]
            self.got["edges"] = self.traffic.all_edges()
            self.got.update(self._embeddings())
        if self.train:
            self.pipe.flush_super(max_ticks=64 * self.T, T=self.T)
            self.got["win"] = self._window_inputs()
        self.pipe = self.sess = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _window_inputs(self):
        """At every vertex ingested by the window's close, on its master:
        layer 0's input row and in-neighbour sum, each layer's in-edge
        count, and whether layer 0 holds the row."""
        pipe = self.pipe
        vids = self.traffic.ingested()
        mp, ms, ok = self._masters(vids)
        s0 = pipe.states[0]
        return {"vids": vids, "edges": self.traffic.all_edges(),
                "has": ok & s0.has_feat[mp, ms], "x": s0.feat[mp, ms],
                "agg": s0.agg[mp, ms],
                "cnt": torch.stack([s.agg_cnt[mp, ms] for s in pipe.states])}

    # ------------------------------------------------------------ check
    def check(self, limits: dict, ref_module) -> list:
        """[(name, value, limit)] of every number compared."""
        dev, got = self.device, self.got
        vids = got["vids"]
        tr = self.traffic
        # the reference's index: ingested vertices in vid order
        edges = got["edges"].astype(np.int64)
        src = torch.as_tensor(np.searchsorted(vids, edges[:, 0])).to(dev)
        dst = torch.as_tensor(np.searchsorted(vids, edges[:, 1])).to(dev)
        x = torch.as_tensor(tr.feats[vids]).to(dev)
        outs, caches = ref_module.forward(x, src, dst, self.weights)
        h_got = [h.to(dev) for h in got["h"]]
        if self.control == "tf32":
            h_got, _ = ref_module.forward(x, src, dst, self.weights, "tf32")
        seen = torch.as_tensor(got["seen"]).to(dev)
        rows = []
        rows.append(("unmaterialized", int((~seen).sum()),
                     limits["unmaterialized"]))
        for l, (g, r) in enumerate(zip(h_got, outs)):
            rows.append((f"h{l + 1}_err", compare.rel_max(g[seen], r[seen]),
                         limits[f"h{l + 1}_err"]))
        if self.serve:
            rows += self._check_answers(outs[-1], h_got[-1], vids, limits)
        if self.train:
            rows += self._check_train(ref_module, caches, outs, src, dst,
                                      vids, limits)
            rows += self._check_window(ref_module, limits)
        return rows

    def _check_window(self, ref_module, limits):
        """The window's ingest: every ingested vertex held, its layer-0
        row exact, each layer's in-edge count exact, the layer-0
        in-neighbour sum against the reference's (the half-batch control
        puts the reference's over every other edge in the program's
        place)."""
        w, dev = self.got["win"], self.device
        vids = w["vids"]
        e = torch.as_tensor(np.searchsorted(vids, w["edges"].astype(
            np.int64))).to(dev)
        x = torch.as_tensor(self.traffic.feats[vids]).to(dev)
        agg, cnt = ref_module.neighbour_sum(x.double(), e[:, 0], e[:, 1],
                                            len(vids))
        got_agg, got_cnt = w["agg"], w["cnt"]
        if self.control == "half_batch":
            got_agg, c = ref_module.neighbour_sum(x.double(), e[::2, 0],
                                                  e[::2, 1], len(vids))
            got_cnt = c.expand(got_cnt.shape)
        has = w["has"]
        return [("win_missing", int((~has).sum()), limits["win_missing"]),
                ("win_x_wrong", int((w["x"][has] != x[has]).any(1).sum()),
                 limits["win_x_wrong"]),
                ("win_cnt_wrong", int((got_cnt[:, has].double() != cnt[has]
                                       ).any(0).sum()),
                 limits["win_cnt_wrong"]),
                ("win_agg_err", compare.rel_max(got_agg[has], agg[has]),
                 limits["win_agg_err"])]

    def _check_answers(self, ref_out, got_out, vids, limits):
        """Consistent reads: every one answered ok, EMBED rows and LINK
        scores against the reference (the control reads its own rows)."""
        got, ctl = self.got, self.control == "tf32"
        ix = lambda v: int(np.searchsorted(vids, v))
        missing, e_err, l_err = 0, 0.0, 0.0
        for v, a in got["embed"]:
            if a is None or not a.ok:
                missing += 1
                continue
            vec = (got_out[ix(v)] if ctl else
                   torch.as_tensor(a.vec).to(ref_out.device))
            e_err = max(e_err, compare.rel_max(vec, ref_out[ix(v)]))
        for (u, v), a in got["link"]:
            if a is None or not a.ok:
                missing += 1
                continue
            ru, rv = ref_out[ix(u)], ref_out[ix(v)]
            score = (float(got_out[ix(u)].double() @ got_out[ix(v)].double())
                     if ctl else a.score)
            e_scale = max(1.0, float((ru * rv).abs().sum()))
            l_err = max(l_err, abs(score - float(ru @ rv)) / e_scale)
        return [("consistent_missing", missing, limits["consistent_missing"]),
                ("embed_err", e_err, limits["embed_err"]),
                ("link_err", l_err, limits["link_err"])]

    def _check_train(self, ref_module, caches, outs, src, dst, vids, limits):
        got, dev = self.got, self.device
        part = torch.as_tensor(got["master_part"][vids].astype(np.int64)
                               ).to(dev)
        steps = [(torch.as_tensor(np.searchsorted(vids, r)).to(dev),
                  torch.as_tensor(self.traffic.classes[r].astype(np.int64)
                                  ).to(dev)) for r in got["steps"]]
        args = (self.weights, caches, outs[-1], src, dst, part,
                self.cfg["n_parts"], steps, self.train)
        ref = ref_module.train_steps(*args)
        if self.control:
            # the reference in the program's place: in TF32, or in float64
            # on the first half of each step's labels
            if self.control == "half_batch":
                half = [(r[:len(r) // 2], y[:len(y) // 2]) for r, y in steps]
                ctl = ref_module.train_steps(*args[:7], half, self.train)
            else:
                ctl = ref_module.train_steps(*args, precision=self.control)
            prog = {"loss": ctl["loss"], "sent1": _to_host(ctl["sent1"]),
                    "params": _to_host(ctl["params"])}
            fired = list(range(1, len(steps) + 1))
        else:
            prog, fired = got, got["fired"]
        n = len(steps)
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(prog["loss"], ref["loss"]))
        ref_sent1 = _to_host(ref["sent1"])
        grad_gap = compare.median_leaf_gap(prog["sent1"], ref_sent1)
        w0 = _to_host(self.weights)
        ref_change = _map(lambda a, b: a - b, _to_host(ref["params"]), w0)
        got_change = _map(lambda a, b: a - b, prog["params"], w0)
        keep = compare.moving_leaves(ref_sent1)
        change_gap = compare.median_leaf_gap(got_change, ref_change, keep)
        # a look, not a check: every leaf's gaps, and (the program's runs)
        # the last step's gradient before compression, the plane's last_grad
        look = {"grad1": compare.leaf_gaps(prog["sent1"], ref_sent1),
                "change3": compare.leaf_gaps(got_change, ref_change, keep),
                "loss": [prog["loss"], ref["loss"]]}
        if not self.control:
            look["last_grad"] = compare.leaf_gaps(got["last_grad"],
                                                  _to_host(ref["last_grad"]))
        print(f"leaf gaps: {json.dumps(look)}", file=sys.stderr)
        return [("steps_fired", int(fired != list(range(1, n + 1))),
                 limits["steps_fired"]),
                ("loss_gap", loss_gap, limits["loss_gap"]),
                ("grad1_gap", grad_gap, limits["grad1_gap"]),
                ("change3_gap", change_gap, limits["change3_gap"])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _to_host(tree):
    return _map(lambda x: x.detach().to("cpu", torch.float64), tree)


def _tree(ts) -> dict:
    """The live parameters of a training state in the weights' layout."""
    out = dict(ts.params)
    out["head"] = ts.head_params
    return out
