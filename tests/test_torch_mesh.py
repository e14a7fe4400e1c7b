"""The port's sharded 1-D mesh path against the JAX package's, on the CPU.

Four gloo ranks (`launch/mesh.py:spawn_stream_mesh`, CPU tensors, so the
wrappers run their plain versions) stream test_route_plane.py's
hub-skewed cases through `D3Pipeline(mesh=...)`; a subprocess runs the
same cases through the JAX D3Pipeline on a forced 4-device CPU mesh
(`JAX_PLATFORMS=cpu`, `--xla_force_host_platform_device_count=4
--xla_backend_optimization_level=0`, as conftest.run_forced_devices
does). Both start together; each has its own timeout.

Cases: route_cap in {None (dense), 40 (the RMI lane's C // D), 2} x
{per-tick, super-tick}, an ADAPTIVE-window case (the CountMinSketch
delta is psum'd over the ranks), the starved ring (route_cap=1,
route_defer_cap=0) and cap 2 on the port's "scatter" backends (JAX runs
its "xla" backend throughout). The query plane (QCASES): the golden query
mix of tests/test_query_plane.py plus a burst of link queries onto one hub
(the link-tail wire rides layer 0's round-B exchange) at route_cap None
and 2 (the wire lane defers), per-tick and super-tick.

Tolerances: every integer TickStats field of every tick/super-tick call
and every StreamMetrics counter (wire_rows, wire_bytes, route_deferred
and route_dropped included), the busy vector and the final aggregator
counts exactly equal; embeddings within 1e-5 (absolute and relative) of
JAX's; the sink within 1e-4 of the port's static oracle (core/oracle.py).
Answers: qid, kind, ok, tick and issue exactly equal, vec within
rtol = atol = 1e-5, score within rtol 1e-4, atol 1e-5 (the golden
matrix's own tolerances), and the query counters exactly equal.

Delta gating and training (GCASES, TCASES): test_delta_gating.py's
stream plus two waves of sub-eps feature updates at delta_eps 1e-3 over
a capped exchange (route_cap 2: the coalesced RMI lane defers), per-tick
and super-tick — every integer stat of every call (suppressed included)
and the wire counters exactly equal, embeddings within 1e-5; and
test_train_plane.py's quiescent-gradient run (lr 0, one label tick after
the flush; dims (8, 16, 16), 4 classes) at route_cap 2, where the
gradient lanes stay dense — steps exactly equal, loss and every
last_grad leaf within rtol 1e-5, atol 1e-6 of JAX's 4-device run, and
the same within the port between the 4-rank run and a one-rank run.

The telemetry plane (TELCASES): the query stream at route_cap 2 with
telemetry on, per-tick and super-tick — every device column and integer
host column of the trace equal JAX's 4-device trace, the ring gauges
equal the summed per-rank ring populations after every tick, the straggler
feed fed once a tick, and the stats other than the gauges equal the
telemetry-free case; a persistent straggler on shard 1 makes
`mitigate_stragglers` reshard onto shards 0 and 2 (JAX's rescale plan). Checkpoints (CKCASES): held
consistent queries cut on the 4 ranks (rank 0 writes the gathered global
layout) restore into fresh ranks and answer as the uninterrupted run does;
the same blob restores into a local port pipeline and a local JAX pipeline,
which answer the same (qid, tick, ok exactly; vec within 1e-5).
"""
import hashlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.graph.sage import GraphSAGE
from repro_torch.launch.mesh import spawn_stream_mesh

REPO = Path(__file__).resolve().parents[1]
N_NODES, D_IN, DIMS = 32, 8, (8, 12, 12)
N_RANKS = 4
TIMEOUT = 300

# name: (hub_stream seed, driver, route_cap, route_defer_cap, window,
#        edges streamed (None = all), flushed)
CASES = {
    "dense-tick": (0, "tick", None, None, win.STREAMING, None, True),
    "dense-super": (0, "super", None, None, win.STREAMING, None, True),
    "cap40-tick": (0, "tick", 40, None, win.STREAMING, None, True),
    "cap40-super": (0, "super", 40, None, win.STREAMING, None, True),
    "cap2-tick": (0, "tick", 2, None, win.STREAMING, None, True),
    "cap2-super": (0, "super", 2, None, win.STREAMING, None, True),
    "adaptive-cap40-super": (5, "super", 40, None, win.ADAPTIVE, None, True),
    "starved-tick": (7, "tick", 1, 0, win.STREAMING, 48, False),
    # the port's "scatter" backends (plain route_pack and delivery)
    "cap2-super-scatter": (0, "super", 2, None, win.STREAMING, None, True),
}
METRICS = ("ticks", "emitted_total", "reduce_msgs", "broadcast_msgs",
           "cross_part_msgs", "dropped", "wire_rows", "wire_bytes",
           "route_deferred", "route_dropped")
QMETRICS = METRICS + ("queries_admitted", "queries_answered",
                      "queries_dropped", "query_hold_ticks")
# the query plane on the mesh: name -> (driver, route_cap)
QCASES = {
    "q-dense-tick": ("tick", None),
    "q-dense-super": ("super", None),
    "q-cap2-tick": ("tick", 2),
    "q-cap2-super": ("super", 2),
}
KIND_EMBED, KIND_LINK = 0, 1
STAT_FIELDS = ("broadcast_msgs", "reduce_msgs", "cross_part_msgs", "emitted",
               "dropped", "wire_rows", "route_deferred", "route_dropped",
               "n_suppressed")
# delta gating on the mesh: name -> (driver, route_cap)
GCASES = {"gate-cap2-tick": ("tick", 2), "gate-cap2-super": ("super", 2)}
GMETRICS = METRICS + ("suppressed",)
GATE_EPS = 1e-3
# the training plane on the mesh: name -> route_cap (the data plane's;
# the gradient lanes are dense)
TCASES = {"train-cap2-super": 2}
T_DIMS, T_CLS = (8, 16, 16), 4
# the telemetry plane on the mesh: name -> (driver, route_cap)
TELCASES = {"tel-cap2-tick": ("tick", 2), "tel-cap2-super": ("super", 2)}
TEL_GAUGES = ("occ_bc_defer", "occ_rmi_defer", "route_peak",
              "outbox_part_peak")
# held consistent queries through a checkpoint on the mesh
CKPT_QUERIES = lambda u, v: [(1, KIND_EMBED, u, True),
                             (2, KIND_LINK, u, v, True),
                             (3, KIND_EMBED, v, False)]


def hub_stream(seed=0, n_edges=120):
    """test_route_plane.hub_stream, here without jax: most edges point at
    hubs 0..2, so RMIs converge on one rank and overflow small buckets."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, N_NODES, n_edges)
    dst = np.where(rng.random(n_edges) < 0.75,
                   rng.integers(0, 3, n_edges),
                   rng.integers(0, N_NODES, n_edges))
    edges = np.stack([src, dst], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def q_stream(seed=0, n_edges=100):
    """test_query_plane.make_stream, here without jax."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def q_plan(edges):
    """Per-chunk query lists: a burst of stale_ok links from every vertex
    onto the busiest in-degree hub (tails converge on one rank and
    overflow a 2-row bucket; parts past their 8 pending slots answer
    ok=False), consistent links onto the hub, then the golden mix."""
    u, v = int(edges[0, 0]), int(edges[0, 1])
    hub = int(np.bincount(edges[:, 1]).argmax())
    return {1: [(100 + w, KIND_LINK, w, hub, False)
                for w in range(N_NODES) if w != hub],
            2: [(200 + w, KIND_LINK, w, hub, True)
                for w in range(0, N_NODES, 5) if w != hub],
            3: [(1, KIND_EMBED, 0, False), (2, KIND_LINK, u, v, True),
                (3, KIND_EMBED, 5, True), (4, KIND_LINK, u, 5, False)]}


def drive_queries(pipe, name, edges, feats, record, ring=None):
    """Stream the query case through its driver, recording each call's
    integer TickStats (and, per tick, the wire ring's occupied rows into
    `ring` when given). Returns the answers sorted by qid."""
    driver = QCASES[name][0]
    _record_calls(pipe, record)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    plan = q_plan(edges)
    if driver == "tick":
        for i, (ch, fe) in enumerate(zip(e_chunks, f_chunks)):
            pipe.tick(ch, fe, queries=plan.get(i))
            if ring is not None:
                ring.append(int(pipe.queries.wire_defer_ok.sum()))
        pipe.flush(max_ticks=256)
    else:
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks),
                            query_chunks=[plan.get(i)
                                          for i in range(len(e_chunks))])
        pipe.flush_super(max_ticks=256, T=4)
    ans = pipe.drain_answers()
    order = np.argsort(ans["qid"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in ans.items()}


def update_waves(feats, n_waves=2, scale=1e-4, seed=13):
    """test_delta_gating._tiny_update_waves, here without jax."""
    rng = np.random.default_rng(seed)
    cur = {v: np.asarray(f, np.float32).copy() for v, f in feats.items()}
    waves = []
    for _ in range(n_waves):
        events = []
        for v in sorted(cur):
            delta = rng.normal(size=D_IN).astype(np.float32)
            delta *= scale / max(float(np.linalg.norm(delta)), 1e-12)
            cur[v] = cur[v] + delta
            events.append((v, cur[v].copy()))
        waves.append(events)
    return waves


def drive_gated(pipe, name, edges, feats, record):
    """Stream, flush, two waves of sub-eps updates, flush."""
    driver = GCASES[name][0]
    _record_calls(pipe, record)
    if driver == "tick":
        pipe.run_stream(edges, feats, tick_edges=24)
        pipe.flush(max_ticks=256)
        for events in update_waves(feats):
            pipe.tick(feats=events)
        pipe.flush(max_ticks=256)
    else:
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        pipe.flush_super(max_ticks=256, T=4)
        for events in update_waves(feats):
            pipe.run_super_tick(feat_chunks=[events], T=1)
        pipe.flush_super(max_ticks=256, T=4)
    return pipe


def drive_train(pipe, labels):
    """test_train_plane._quiescent_grad_run: stream, flush, one label
    tick. Returns (train_stats, last_grad as numpy leaves in jax.tree
    order: head.b, head.w, then each layer's neigh.w, self.b, self.w)."""
    edges, feats = q_stream()
    pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
    pipe.flush_super(max_ticks=160, T=4)
    pipe.run_super_tick(T=1, label_chunks=[list(labels.items())])
    return pipe.train_stats(), pipe.train_state.last_grad


def train_labels():
    return {v: (v * 7 + 3) % T_CLS for v in range(N_NODES)}


def tel_config(cap, telemetry=True):
    return dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                route_cap=cap, telemetry=telemetry,
                window=win.WindowConfig(kind=win.STREAMING))


def drive_tel(pipe, name, edges, feats, record, rings=None):
    """Stream + flush a telemetry case, recording every call's integer
    TickStats (gauges included) and, per tick, this rank's ring
    populations into `rings`."""
    driver = TELCASES[name][0]
    fields = STAT_FIELDS + TEL_GAUGES
    tick, sup = pipe.tick, pipe.run_super_tick

    def rec(stats):
        record.append([[int(getattr(s, f)) for f in fields] for s in stats])

    def tick_rec(*a, **k):
        out = tick(*a, **k)
        rec(out)
        if rings is not None:
            rings.append([[int(ls.bc_defer_ok.sum()),
                           int(ls.rmi_defer_ok.sum())]
                          for ls in pipe.states])
        return out

    def sup_rec(*a, **k):
        out = sup(*a, **k)
        rec(out[0])
        return out

    pipe.tick, pipe.run_super_tick = tick_rec, sup_rec
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    if driver == "tick":
        for e, f in zip(e_chunks, f_chunks):
            pipe.tick(e, f)
        for _ in range(16):
            pipe.tick()
    else:
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks))
        pipe.run_super_tick(T=16)
    return pipe


def tel_summary(pipe, record):
    cols = pipe.trace.columns()
    from repro_torch.telemetry.trace import TRACE_DEVICE_COLS
    keys = TRACE_DEVICE_COLS + ["tick", "ticks", "amortized", "wire_bytes",
                                "edges_in", "feats_in"]
    m = pipe.metrics
    return {"cols": {k: np.asarray(cols[k]) for k in keys},
            "stats": record, "ticks_observed": pipe.straggler.ticks_observed,
            "peaks": [int(m.route_peak), int(m.outbox_peak),
                      int(m.outbox_part_peak), int(m.occ_defer_ticks)],
            "metrics": {k: int(getattr(m, k)) for k in METRICS}}


def _record_calls(pipe, record):
    """Record the integer TickStats of every tick / super-tick call."""
    tick, sup = pipe.tick, pipe.run_super_tick

    def rec(stats):
        record.append([[int(getattr(s, f)) for f in STAT_FIELDS]
                       + [int(v) for v in np.asarray(s.busy)]
                       for s in stats])

    def tick_rec(*a, **k):
        out = tick(*a, **k)
        rec(out)
        return out

    def sup_rec(*a, **k):
        out = sup(*a, **k)
        rec(out[0])
        return out

    pipe.tick, pipe.run_super_tick = tick_rec, sup_rec


def case_config(name):
    """test_route_plane.build_pipe's config for one case."""
    _, _, cap, defer, kind, _, _ = CASES[name]
    return dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                route_cap=cap, route_defer_cap=defer,
                delivery_backend="scatter" if name.endswith("scatter")
                else "kernel")


def drive(pipe, name, edges, feats, record):
    """Stream one case as test_route_plane.run_capped does, recording the
    integer TickStats of every tick / super-tick call."""
    _, driver, _, _, _, n_edges, flushed = CASES[name]
    _record_calls(pipe, record)
    if n_edges is not None:
        edges = edges[:n_edges]
    if driver == "tick":
        pipe.run_stream(edges, feats, tick_edges=24)
        if flushed:
            pipe.flush(max_ticks=256)
    else:
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        if flushed:
            pipe.flush_super(max_ticks=256, T=4)
    return pipe


def summary(pipe, record, keys=METRICS):
    m = pipe.metrics
    return {"metrics": {k: int(getattr(m, k)) for k in keys},
            "busy": np.asarray(m.busy_logical, np.int64),
            "stats": record, "emb": pipe.embeddings()}


# ------------------------------------------------------------ port side

def _ckpt_rank(mesh, params, ckpt_dir):
    """Held consistent queries through a checkpoint on the mesh: cut,
    restore into fresh ranks, finish both; the blob is kept for the
    local restores of the test."""
    from repro_torch.ft.checkpoint import CheckpointManager

    def make():
        model = GraphSAGE(DIMS)
        model.load_state_dict(params)
        return D3Pipeline(model, PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES, query_cap=8,
            window=win.WindowConfig(kind=win.TUMBLING, interval=4)),
            mesh=mesh)

    edges, feats = q_stream()
    u, v = int(edges[0, 0]), int(edges[0, 1])
    pipe = make()
    pipe.run_stream(edges[:72], feats, tick_edges=24)
    pipe.tick(edges[72:], queries=CKPT_QUERIES(u, v))
    pipe.drain_answers()
    held = int(mesh.all_reduce(pipe.queries.pending.sum()))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save_pipeline(step=1, pipe=pipe)
    pipe2 = make()
    step = mgr.restore_pipeline(pipe2)
    same = all(torch.equal(a, b) for a, b in zip(
        (pipe.queries.pending, pipe.sink, pipe.states[0].agg),
        (pipe2.queries.pending, pipe2.sink, pipe2.states[0].agg)))
    out = {"held": held, "step": step, "same_at_cut": same,
           "dir": ckpt_dir}
    for key, p in (("uninterrupted", pipe), ("restored", pipe2)):
        p.flush(max_ticks=128)
        ans = p.drain_answers()
        order = np.argsort(ans["qid"], kind="stable")
        out[key] = {k: np.asarray(val)[order] for k, val in ans.items()}
    out["emb"] = pipe2.embeddings()
    return out


def _port_rank(mesh, params, tparams, ckpt_dir):
    """One rank: every case, on CPU tensors. Returns per case the rank's
    aggregator-count blocks, a digest of the host batches it built and
    (all ranks alike) the summary."""
    out = {}
    for name, (seed, _, _, _, kind, _, _) in CASES.items():
        edges, feats = hub_stream(seed)
        model = GraphSAGE(DIMS)
        model.load_state_dict(params)
        pipe = D3Pipeline(model, PipelineConfig(
            **case_config(name), window=win.WindowConfig(kind=kind)),
            mesh=mesh)
        digest = hashlib.sha256()
        build = pipe._build_batches

        def build_hashed(*a, **k):
            batches = build(*a, **k)
            for b in batches:
                for f in b.__dataclass_fields__:
                    digest.update(np.ascontiguousarray(
                        np.asarray(getattr(b, f))).tobytes())
            return batches

        pipe._build_batches = build_hashed
        record = []
        drive(pipe, name, edges, feats, record)
        res = summary(pipe, record)
        res["agg_cnt"] = [ls.agg_cnt.numpy() for ls in pipe.states]
        res["digest"] = digest.hexdigest()
        res["ring_rows"] = [ls.rmi_defer.shape[0] for ls in pipe.states]
        res["shards"] = [p.tolist() for p in pipe.parts_per_shard()]
        res["part0"] = pipe.router.part0()
        out[name] = res
    for name, (_, cap) in QCASES.items():
        edges, feats = q_stream()
        model = GraphSAGE(DIMS)
        model.load_state_dict(params)
        pipe = D3Pipeline(model, PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES, query_cap=8,
            route_cap=cap, window=win.WindowConfig(kind=win.STREAMING)),
            mesh=mesh)
        record, ring = [], []
        ans = drive_queries(pipe, name, edges, feats, record, ring)
        res = summary(pipe, record, QMETRICS)
        res["answers"], res["ring"] = ans, ring
        res["wire_rows_cap"] = pipe.queries.wire_defer.shape[0]
        out[name] = res
    for name, (_, cap) in GCASES.items():
        edges, feats = q_stream()
        model = GraphSAGE(DIMS)
        model.load_state_dict(params)
        pipe = D3Pipeline(model, PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
            route_cap=cap, delta_eps=GATE_EPS,
            window=win.WindowConfig(kind=win.STREAMING)), mesh=mesh)
        record = []
        drive_gated(pipe, name, edges, feats, record)
        out[name] = summary(pipe, record, GMETRICS)
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    for name, cap in TCASES.items():
        model = GraphSAGE(T_DIMS, n_classes=T_CLS)
        model.load_state_dict(tparams)
        pipe = D3Pipeline(model, PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
            route_cap=cap, train_cap=64,
            window=win.WindowConfig(kind=win.STREAMING)), mesh=mesh,
            train=TrainConfig(optimizer=sgd(), lr=0.0, batch_threshold=1))
        st, grads = drive_train(pipe, train_labels())
        out[name] = {"stats": st, "grads": [g.numpy() for g in
                                            tree_leaves(grads)],
                     "metrics": {k: int(getattr(pipe.metrics, k))
                                 for k in METRICS}}
    for name, (_, cap) in TELCASES.items():
        edges, feats = q_stream()
        res = {}
        for tel in (True, False):
            model = GraphSAGE(DIMS)
            model.load_state_dict(params)
            pipe = D3Pipeline(model, PipelineConfig(**tel_config(cap, tel)),
                              mesh=mesh)
            record, rings = [], []
            drive_tel(pipe, name, edges, feats, record, rings)
            if tel:
                res = tel_summary(pipe, record)
                res["rings"] = rings
                # a persistent straggler on shard 1: the live reshard
                # onto the survivors (4 -> 3 -> 2, a divisor of 4 parts)
                pipe.straggler._flags[1] = pipe.straggler.patience
                plan = pipe.mitigate_stragglers()
                res["mitigate"] = {
                    "moves": plan.moves, "active": pipe.active,
                    "n_data": pipe._n_data,
                    "shards": [p.tolist() for p in pipe.parts_per_shard()],
                    "emb": pipe.embeddings() if pipe.active else None,
                    # collective over the world: every rank calls it
                    "again": pipe.mitigate_stragglers()}
            else:
                res["off_stats"] = record
        out[name] = res
    out["ckpt-held"] = _ckpt_rank(mesh, params, ckpt_dir)
    return out


# ------------------------------------------------------------- JAX side

def jax_reference(path):
    """Run every case through the JAX D3Pipeline on a 4-device mesh and
    pickle the summaries (the forced-device subprocess's entry point)."""
    import jax

    sys.path.insert(0, str(REPO / "tests"))
    from repro.core import windowing as jwin
    from repro.launch.mesh import make_stream_mesh
    from test_route_plane import build_pipe
    from test_route_plane import hub_stream as jax_hub_stream

    mesh = make_stream_mesh(N_RANKS)
    out = {}
    for name, (seed, _, cap, defer, kind, _, _) in CASES.items():
        if name.endswith("-scatter"):
            continue                    # the same JAX run as without
        edges, feats = jax_hub_stream(seed)
        model, params, pipe = build_pipe(jwin.WindowConfig(kind=kind),
                                         mesh=mesh, route_cap=cap,
                                         route_defer_cap=defer)
        record = []
        drive(pipe, name, edges, feats, record)
        res = summary(pipe, record)
        res["agg_cnt"] = [np.asarray(ls.agg_cnt) for ls in pipe.states]
        res["edges"] = edges
        res["params"] = jax.tree.map(np.asarray, params)
        out[name] = res
    for name, (_, cap) in QCASES.items():
        edges, feats = q_stream()
        _, _, pipe = build_pipe(jwin.WindowConfig(kind=jwin.STREAMING),
                                mesh=mesh, route_cap=cap, query_cap=8)
        record = []
        ans = drive_queries(pipe, name, edges, feats, record)
        res = summary(pipe, record, QMETRICS)
        res["answers"] = ans
        out[name] = res
    from repro.core.pipeline import D3Pipeline as JaxPipeline
    from repro.core.pipeline import PipelineConfig as JaxConfig
    from repro.core.train_plane import TrainConfig as JaxTrainConfig
    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro.optim import sgd as jsgd
    caps = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                window=jwin.WindowConfig(kind=jwin.STREAMING))
    for name, (_, cap) in GCASES.items():
        edges, feats = q_stream()
        jm = JaxSAGE(DIMS)
        pipe = JaxPipeline(jm, jm.init(jax.random.key(0)), JaxConfig(
            **caps, route_cap=cap, delta_eps=GATE_EPS), mesh=mesh)
        record = []
        drive_gated(pipe, name, edges, feats, record)
        out[name] = summary(pipe, record, GMETRICS)
    for name, cap in TCASES.items():
        jm = JaxSAGE(T_DIMS, n_classes=T_CLS)
        jp = jm.init(jax.random.key(0))
        pipe = JaxPipeline(jm, jp, JaxConfig(**caps, route_cap=cap,
                                             train_cap=64), mesh=mesh,
                           train=JaxTrainConfig(optimizer=jsgd(), lr=0.0,
                                                batch_threshold=1))
        st, grads = drive_train(pipe, train_labels())
        out[name] = {"stats": st, "grads": [np.asarray(g) for g in
                                            jax.tree.leaves(grads)],
                     "metrics": {k: int(getattr(pipe.metrics, k))
                                 for k in METRICS},
                     "params": jax.tree.map(np.asarray, jp)}
    for name, (_, cap) in TELCASES.items():
        edges, feats = q_stream()
        jm = JaxSAGE(DIMS)
        pipe = JaxPipeline(jm, jm.init(jax.random.key(0)), JaxConfig(
            **dict(tel_config(cap), window=jwin.WindowConfig(
                kind=jwin.STREAMING))), mesh=mesh)
        record = []
        drive_tel(pipe, name, edges, feats, record)
        out[name] = tel_summary(pipe, record)
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX summaries, port per-rank results), the two computed side by
    side: the forced-4 JAX subprocess starts first, the gloo ranks run
    while it compiles."""
    import jax

    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro_torch.convert import params_from_numpy
    out = tmp_path_factory.mktemp("jax_mesh") / "ref.pkl"
    ckpt_dir = tmp_path_factory.mktemp("mesh_ckpt")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS} "
                         "--xla_backend_optimization_level=0 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(out)], env=env,
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        params = params_from_numpy(jax.tree.map(
            np.asarray, JaxSAGE(DIMS).init(jax.random.key(0))))
        tparams = params_from_numpy(jax.tree.map(
            np.asarray, JaxSAGE(T_DIMS, n_classes=T_CLS).init(
                jax.random.key(0))))
        port = spawn_stream_mesh(N_RANKS, _port_rank, backend="gloo",
                                 device="cpu",
                                 args=(params, tparams, str(ckpt_dir)),
                                 timeout=TIMEOUT)
        log, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return ref, port, params, tparams


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax_mesh(runs, name):
    ref, port, params, _ = runs
    want = ref[name.removesuffix("-scatter")]
    edges, feats = hub_stream(CASES[name][0])
    np.testing.assert_array_equal(edges, want["edges"])
    ranks = [p[name] for p in port]
    for rank, r in enumerate(ranks):
        assert r["shards"] == [[0], [1], [2], [3]] and r["part0"] == rank
        assert r["metrics"] == want["metrics"]
        assert r["stats"] == want["stats"]
        np.testing.assert_array_equal(r["busy"], want["busy"])
        # every rank builds the same host batches from the same stream
        assert r["digest"] == ranks[0]["digest"]
        assert set(r["emb"]) == set(want["emb"]) and r["emb"]
        for vid, vec in want["emb"].items():
            np.testing.assert_allclose(r["emb"][vid], vec, rtol=1e-5,
                                       atol=1e-5)
    for li in range(len(DIMS) - 1):
        np.testing.assert_array_equal(
            np.concatenate([r["agg_cnt"][li] for r in ranks]),
            want["agg_cnt"][li])
    m = want["metrics"]
    if name.startswith("starved"):
        assert m["route_dropped"] > 0 and m["route_deferred"] == 0
        assert ranks[0]["ring_rows"] == [0, 0]
        return
    assert m["route_dropped"] == 0, "sized rings must never drop"
    if name.startswith("cap2"):
        assert m["route_deferred"] > 0, "a 2-row bucket must defer"
    if name.startswith("dense"):
        assert ranks[0]["ring_rows"] == [0, 0]
    # the sink against the static oracle on the final snapshot
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    model = GraphSAGE(DIMS)
    model.load_state_dict(params)
    g, _ = build_snapshot(edges, feats, D_IN, N_NODES, "cpu")
    oracle = oracle_embeddings(model, g).numpy()
    for vid, vec in ranks[0]["emb"].items():
        np.testing.assert_allclose(vec, oracle[vid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(QCASES))
def test_mesh_queries_match_jax_mesh(runs, name):
    """The query plane on 4 gloo ranks against JAX's 4-device mesh: the
    same answers tick for tick, the same integer stats and counters."""
    ref, port, *_ = runs
    want = ref[name]
    for r in (p[name] for p in port):
        assert r["metrics"] == want["metrics"]
        assert r["stats"] == want["stats"]
        np.testing.assert_array_equal(r["busy"], want["busy"])
        got, exp = r["answers"], want["answers"]
        for k in ("qid", "kind", "ok", "tick", "issue"):
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
        np.testing.assert_allclose(got["vec"], exp["vec"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["score"], exp["score"], rtol=1e-4,
                                   atol=1e-5)
    r0, m = port[0][name], want["metrics"]
    qids = set(r0["answers"]["qid"].tolist())
    assert qids == set(range(1, 5)) | {q[0] for qs in q_plan(
        q_stream()[0]).values() for q in qs}, "every query answers once"
    assert len(qids) == len(r0["answers"]["qid"])
    assert m["queries_dropped"] > 0 and m["queries_answered"] > 0
    assert m["route_dropped"] == 0
    if "-cap2-" in name:
        assert r0["wire_rows_cap"] == 8 and m["route_deferred"] > 0
        if name.endswith("-tick"):
            assert max(r0["ring"]) > 0, "the wire lane never deferred"
    else:
        assert r0["wire_rows_cap"] == 0


@pytest.mark.parametrize("name", list(GCASES))
def test_mesh_gating_matches_jax_mesh(runs, name):
    """Delta gating on 4 gloo ranks against JAX's 4-device mesh: the
    coalesced, gated RMI lane over a 2-row bucket gives the same stats
    (suppressed included) call for call."""
    ref, port, *_ = runs
    want = ref[name]
    for r in (p[name] for p in port):
        assert r["metrics"] == want["metrics"]
        assert r["stats"] == want["stats"]
        np.testing.assert_array_equal(r["busy"], want["busy"])
        assert set(r["emb"]) == set(want["emb"]) and r["emb"]
        for vid, vec in want["emb"].items():
            np.testing.assert_allclose(r["emb"][vid], vec, rtol=1e-5,
                                       atol=1e-5)
    m = want["metrics"]
    assert m["suppressed"] > 0 and m["route_deferred"] > 0
    assert m["route_dropped"] == 0


def _one_rank_train(tparams, cap):
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    model = GraphSAGE(T_DIMS, n_classes=T_CLS)
    model.load_state_dict(tparams)
    pipe = D3Pipeline(model, PipelineConfig(
        n_parts=4, node_cap=32, edge_cap=128, repl_cap=128, feat_cap=128,
        edge_tick_cap=32, max_nodes=N_NODES, route_cap=cap, train_cap=64,
        window=win.WindowConfig(kind=win.STREAMING)), device="cpu",
        train=TrainConfig(optimizer=sgd(), lr=0.0, batch_threshold=1))
    st, grads = drive_train(pipe, train_labels())
    return st, [g.numpy() for g in tree_leaves(grads)]


@pytest.mark.parametrize("name", list(TCASES))
def test_mesh_training_matches_jax_mesh(runs, name):
    """lr 0 quiescent gradients on 4 gloo ranks (hops A and B on the
    wire) against JAX's 4-device run and the port's one-rank run."""
    ref, port, _, tparams = runs
    want = ref[name]
    one_st, one_grads = _one_rank_train(tparams, TCASES[name])
    for r in (p[name] for p in port):
        assert r["metrics"] == want["metrics"]
        for st, grads in ((want["stats"], want["grads"]),
                          (one_st, one_grads)):
            assert r["stats"]["steps"] == st["steps"] == 1
            np.testing.assert_allclose(r["stats"]["loss"], st["loss"],
                                       rtol=1e-5, atol=1e-6)
            assert len(r["grads"]) == len(grads)
            for a, b in zip(r["grads"], grads):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert want["metrics"]["wire_bytes"] > 0


def test_capped_wire_is_smaller_than_dense(runs):
    ref, port, *_ = runs
    dense = port[0]["dense-super"]["metrics"]["wire_bytes"]
    assert port[0]["cap2-super"]["metrics"]["wire_bytes"] < \
        port[0]["cap40-super"]["metrics"]["wire_bytes"] < dense


def test_mesh_config_validation():
    """Indivisible parts and bad route caps fail in validate(n_devices),
    before any rank allocates; so does a capped query wire that cannot
    defer (a dropped link tail would strand its qid), as in JAX."""
    with pytest.raises(ValueError, match="not divisible"):
        PipelineConfig(n_parts=6, feat_cap=6).validate(n_devices=4)
    PipelineConfig(n_parts=8, feat_cap=8).validate(n_devices=4)
    cfg = PipelineConfig(n_parts=4, feat_cap=4, route_cap=1,
                         route_defer_cap=0, query_cap=8)
    with pytest.raises(ValueError, match="route_defer_cap=0 with a capped"):
        cfg.validate(n_devices=4)
    with pytest.raises(ValueError, match="route_cap=0 must be > 0"):
        PipelineConfig(route_cap=0, feat_cap=8).validate()
    with pytest.raises(ValueError, match="route_defer_cap=-1"):
        PipelineConfig(route_defer_cap=-1, feat_cap=8).validate()
    # ring rows: global, 0 where the bucket holds the whole lane
    caps = PipelineConfig(n_parts=4, edge_cap=128, repl_cap=128,
                          feat_cap=128, edge_tick_cap=32,
                          route_cap=40).capacities(4)
    assert (caps.bc_defer_rows, caps.rmi_defer_rows) == (4 * 128, 4 * 160)
    assert PipelineConfig(n_parts=4, route_cap=200, feat_cap=8,
                          edge_tick_cap=32, edge_cap=128).capacities(
        4).rmi_defer_rows == 0
    assert PipelineConfig(n_parts=4, route_cap=2, feat_cap=8).capacities(
        1).rmi_defer_rows == 0


@pytest.mark.parametrize("name", list(TELCASES))
def test_mesh_telemetry_matches_jax_mesh(runs, name):
    """The trace of 4 gloo ranks at route_cap 2 equals JAX's 4-device
    trace column for column; the ring gauges equal the ranks' summed
    ring populations; telemetry changes no other stat. Then a persistent
    straggler on shard 1: `mitigate_stragglers` reshards onto data shards
    0 and 2 with JAX's rescale plan, the removed ranks keep nothing, and
    the restarted feed flags nothing."""
    from repro.ft import elastic as jel
    ref, port, *_ = runs
    want = ref[name]
    ranks = [p[name] for p in port]
    for r in ranks:
        for k, col in want["cols"].items():
            np.testing.assert_array_equal(r["cols"][k], col, err_msg=k)
        assert r["stats"] == want["stats"]
        assert r["peaks"] == want["peaks"]
        assert r["metrics"] == want["metrics"]
        assert r["ticks_observed"] == want["ticks_observed"]
        mit = r["mitigate"]
        assert mit["n_data"] == 2 and mit["shards"] == [[0, 1], [2, 3]]
        assert mit["moves"] == jel.rescale_parts(4, 2, 4).moves
        assert mit["again"] is None
        n = len(STAT_FIELDS)
        for call, off in zip(r["stats"], r["off_stats"]):
            for s_on, s_off in zip(call, off):
                assert s_on[:n] == s_off[:n]
                assert s_off[n:] == [0] * len(TEL_GAUGES)
    assert [r["mitigate"]["active"] for r in ranks] == [True, False, True,
                                                        False]
    e0, e2 = ranks[0]["mitigate"]["emb"], ranks[2]["mitigate"]["emb"]
    assert set(e0) == set(e2) and e0
    for v in e0:
        np.testing.assert_array_equal(e0[v], e2[v])
    cols = ranks[0]["cols"]
    assert cols["route_peak"].max() > 2, "demand must pass the cap"
    assert cols["occ_rmi_defer"].max() > 0
    assert (cols["route_peak"] <= cols["wire_rows"] + cols["route_deferred"]
            + cols["route_dropped"]).all()
    if name.endswith("-tick"):
        rings = np.asarray([r["rings"] for r in ranks]).sum(axis=0)
        np.testing.assert_array_equal(cols["occ_bc_defer"],
                                      rings[:, :, 0].sum(axis=1))
        np.testing.assert_array_equal(cols["occ_rmi_defer"],
                                      rings[:, :, 1].sum(axis=1))


def test_mesh_checkpoint_restores_held_queries(runs):
    """Held consistent queries cut on 4 ranks answer identically after a
    restore into fresh ranks; the blob (rank 0's gathered global layout)
    restores into a local port pipeline and a local JAX pipeline, which
    answer the same."""
    from repro.ft.checkpoint import CheckpointManager as JaxManager
    from repro_torch.ft.checkpoint import CheckpointManager
    ref, port, params, _ = runs
    ranks = [p["ckpt-held"] for p in port]
    assert ranks[0]["held"] > 0
    for r in ranks:
        assert r["step"] == 1 and r["same_at_cut"]
        assert r["held"] == ranks[0]["held"]
        for k, col in ranks[0]["uninterrupted"].items():
            np.testing.assert_array_equal(r["restored"][k], col, err_msg=k)
            np.testing.assert_array_equal(r["uninterrupted"][k], col)
    want = ranks[0]["uninterrupted"]
    assert list(want["qid"]) == [1, 2]
    import jax
    from repro.core import windowing as jwin
    from repro.core.pipeline import D3Pipeline as JaxPipeline
    from repro.core.pipeline import PipelineConfig as JaxConfig
    from repro.graph.sage import GraphSAGE as JaxSAGE
    caps = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                query_cap=8)
    model = GraphSAGE(DIMS)
    model.load_state_dict(params)
    local = D3Pipeline(model, PipelineConfig(
        **caps, window=win.WindowConfig(kind=win.TUMBLING, interval=4)),
        device="cpu")
    jm = JaxSAGE(DIMS)
    jlocal = JaxPipeline(jm, jm.init(jax.random.key(0)), JaxConfig(
        **caps, window=jwin.WindowConfig(kind=jwin.TUMBLING, interval=4)))
    assert CheckpointManager(ranks[0]["dir"]).restore_pipeline(local) == 1
    assert JaxManager(ranks[0]["dir"]).restore_pipeline(jlocal) == 1
    for p in (local, jlocal):
        p.flush(max_ticks=128)
        ans = p.drain_answers()
        order = np.argsort(ans["qid"], kind="stable")
        got = {k: np.asarray(val)[order] for k, val in ans.items()}
        for k in ("qid", "kind", "ok", "tick", "issue"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["vec"], want["vec"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4,
                                   atol=1e-5)
    emb = local.embeddings()
    assert set(emb) == set(ranks[0]["emb"])
    for vid, vec in ranks[0]["emb"].items():
        np.testing.assert_allclose(emb[vid], vec, rtol=1e-5, atol=1e-5)


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return mesh.rank


def test_a_failing_rank_fails_the_mesh():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn_stream_mesh(2, _failing_rank, backend="gloo", device="cpu",
                          timeout=60)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
