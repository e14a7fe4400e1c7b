"""The port's 2-D ("stage", "data") pipeline against the JAX package's, on
the CPU.

Four gloo ranks (`launch/mesh.py:spawn_stream_mesh(stage=2)`, CPU
tensors, so the wrappers run their plain versions) run
tests/test_pipeline_stage.py's cases through `D3Pipeline(mesh=...)` on a
2 x 1 grid (ranks 0 and 1; ranks 2 and 3 stand outside it) and on a 2 x 2
grid (all four); a subprocess runs the same cases through the JAX
D3Pipeline on a forced 4-device CPU mesh (`make_stream_mesh(n,
stage=2)`). Both start together.

Cases: stage 2 x data 1 over every window policy and both drivers (the
ring's in-flight rows after the stream, its drain by the flush and the
bubble counters ride along); four layers in two rounds; 2 x 2 at the
dense exchange (both drivers) and at route_cap 8 on hub-heavy traffic
(capped back-pressure); the query plane; a stage = 2 checkpoint cut
mid-stream with rows in the ring, restored in both packages; and the
training plane at 2 x 2 (lr 0, quiescent gradients after one label tick).

Tolerances (the ROADMAP's): every integer TickStats field of every call,
every StreamMetrics counter (stage_idle included), the aggregator counts
and the answered qids exactly equal; embeddings within 1e-5 of JAX's; the
sink within 1e-4 of the static oracle; training steps exactly equal,
loss and gradients within rtol 1e-5, atol 1e-6.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.graph.sage import GraphSAGE
from repro_torch.launch.mesh import make_stream_mesh, spawn_stream_mesh

REPO = Path(__file__).resolve().parents[1]
N_NODES, D, N_RANKS, TIMEOUT, N_CLS = 32, 8, 4, 600, 4
WINDOWS = {"streaming": (win.STREAMING, 1), "tumbling": (win.TUMBLING, 3),
           "session": (win.SESSION, 3), "adaptive": (win.ADAPTIVE, 1)}
# name: (data shards, driver, window, layers, route_cap, hub stream)
CASES = {f"2x1-{w}-{drv}": (1, drv, w, 2, None, False)
         for w in WINDOWS for drv in ("tick", "super")}
CASES.update({
    "2x1-4layers-super": (1, "super", "streaming", 4, None, False),
    "2x2-streaming-tick": (2, "tick", "streaming", 2, None, False),
    "2x2-streaming-super": (2, "super", "streaming", 2, None, False),
    "2x2-capped-super": (2, "super", "streaming", 2, 8, True),
})
METRICS = ("ticks", "emitted_total", "reduce_msgs", "broadcast_msgs",
           "cross_part_msgs", "dropped", "wire_rows", "wire_bytes",
           "route_deferred", "route_dropped", "stage_idle",
           "queries_admitted", "queries_answered", "queries_dropped")
STAT_FIELDS = ("broadcast_msgs", "reduce_msgs", "cross_part_msgs", "emitted",
               "dropped", "wire_rows", "route_deferred", "route_dropped",
               "n_suppressed")
KIND_EMBED, KIND_LINK = 0, 1


def make_stream(seed=0, n_edges=100):
    """test_pipeline_stage.make_stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def hub_stream():
    """test_stage2_data2_capped_route_backpressure's hub-heavy stream."""
    rng = np.random.default_rng(1)
    src = rng.integers(1, N_NODES, 120)
    dst = np.where(rng.random(120) < 0.75, rng.integers(0, 3, 120),
                   rng.integers(0, N_NODES, 120))
    edges = np.stack([src, dst], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def cfg_kw(window, route_cap=None, **kw):
    kind, interval = WINDOWS[window]
    return dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                n_stages=2, route_cap=route_cap,
                window=(kind, interval), **kw)


def _record_calls(pipe, record):
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


def drive(pipe, name, edges, feats):
    """Stream and flush one case (either package's pipeline), recording
    every call's integer stats and the ring's rows in flight after the
    stream and after the flush."""
    _, driver, _, _, cap, _ = CASES[name]
    record = []
    _record_calls(pipe, record)
    if driver == "tick":
        pipe.run_stream(edges, feats, tick_edges=24)
        in_flight = pipe._ring_occupancy_host()
        pipe.flush(max_ticks=160)
    else:
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        in_flight = pipe._ring_occupancy_host()
        if cap is None:
            pipe.flush_super(max_ticks=160, T=4)
        else:
            pipe.flush_super(max_ticks=256, T=8)
    m = pipe.metrics
    return {"stats": record, "in_flight": in_flight,
            "left": pipe._ring_occupancy_host(),
            "metrics": {k: int(getattr(m, k)) for k in METRICS},
            "busy": np.asarray(m.busy_logical, np.int64),
            "bubble": pipe.bubble_fraction(), "emb": pipe.embeddings()}


def query_run(pipe):
    """test_stage2_query_plane: stream, flush, four embeds and a link."""
    edges, feats = make_stream()
    pipe.run_stream(edges, feats, tick_edges=24)
    pipe.flush(max_ticks=160)
    vids = sorted(pipe.embeddings())[:4]
    qs = [(i, KIND_EMBED, v, False) for i, v in enumerate(vids)]
    qs.append((len(qs), KIND_LINK, vids[0], vids[1], False))
    pipe.tick(queries=qs)
    pipe.flush(max_ticks=160)
    ans = pipe.drain_answers()
    order = np.argsort(ans["qid"], kind="stable")
    return {"answers": {k: np.asarray(v)[order] for k, v in ans.items()},
            "snap": pipe.read_nodes(vids), "vids": vids,
            "metrics": {k: int(getattr(pipe.metrics, k)) for k in METRICS}}


def ckpt_finish(pipe, edges, feats, half):
    """test_stage2_checkpoint_roundtrip's tail after the cut."""
    seen = set(int(v) for v in edges[:half].reshape(-1))
    e_chunks, f_chunks = pipe.chunk_stream(edges[half:], feats, 24,
                                           seen=set(seen))
    for chunk, f_events in zip(e_chunks, f_chunks):
        pipe.tick(chunk, f_events)
    pipe.flush(max_ticks=160)
    return pipe.embeddings()


def train_labels():
    return {v: (v * 7 + 3) % N_CLS for v in range(N_NODES)}


def train_run(pipe):
    """Stream, flush, one label tick (lr 0: the quiescent gradients)."""
    edges, feats = make_stream()
    pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
    pipe.flush_super(max_ticks=160, T=4)
    pipe.run_super_tick(T=1, label_chunks=[list(train_labels().items())])
    return pipe.train_stats(), pipe.train_state.last_grad


# ------------------------------------------------------------ port side

def _port_cfg(**kw):
    kind, interval = kw.pop("window")
    return PipelineConfig(**kw, window=win.WindowConfig(kind=kind,
                                                        interval=interval))


def _port_pipe(mesh, params, name=None, n_layers=2, **kw):
    model = GraphSAGE((D,) * (n_layers + 1),
                      n_classes=N_CLS if kw.get("train_cap") else 0)
    model.load_state_dict(params)
    train = kw.pop("train", None)
    return D3Pipeline(model, _port_cfg(**kw), mesh=mesh, train=train)


def _port_rank(world, params, params4, tparams, ckpt_dir):
    """One rank: every case on CPU tensors; ranks 2 and 3 sit out the
    2 x 1 grid's cases."""
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    dev = world.device
    grids = {1: make_stream_mesh(dev, stage=2, ranks=[0, 1]),
             2: make_stream_mesh(dev, stage=2)}
    out = {"grid": (grids[2].stage_index, grids[2].data_index)}
    # the checkpoint first: the JAX side restores it once it is written
    mesh = grids[1]
    if mesh.member:
        edges, feats = make_stream()
        half = len(edges) // 2
        pipe = _port_pipe(mesh, params, **cfg_kw("streaming"))
        pipe.run_stream(edges[:half], feats, tick_edges=24)
        in_flight = pipe._ring_occupancy_host()
        mgr = CheckpointManager(ckpt_dir)
        mgr.save_pipeline(0, pipe)
        if mesh.rank == 0:
            (Path(ckpt_dir) / "written").write_text("1")
        fresh = _port_pipe(mesh, params, **cfg_kw("streaming"))
        mgr.restore_pipeline(fresh)
        out["ckpt"] = {"in_flight": in_flight,
                       "restored_in_flight": fresh._ring_occupancy_host(),
                       "straight": ckpt_finish(pipe, edges, feats, half),
                       "restored": ckpt_finish(fresh, edges, feats, half)}
    for name, (n_data, _, window, n_layers, cap, hub) in CASES.items():
        mesh = grids[n_data]
        if not mesh.member:
            continue
        edges, feats = hub_stream() if hub else make_stream()
        pipe = _port_pipe(mesh, params4 if n_layers == 4 else params,
                          n_layers=n_layers, **cfg_kw(window, cap))
        res = drive(pipe, name, edges, feats)
        res["agg_cnt"] = [ls.agg_cnt.numpy() for ls in pipe.states]
        res["ring"] = tuple(pipe.stage_ring.shape)
        out[name] = res
    if grids[1].member:
        out["query"] = query_run(_port_pipe(
            grids[1], params, **cfg_kw("streaming", query_cap=8)))
    pipe = _port_pipe(grids[2], tparams, train_cap=64, **cfg_kw(
        "streaming"), train=TrainConfig(optimizer=sgd(), lr=0.0,
                                        batch_threshold=1))
    st, grads = train_run(pipe)
    out["train"] = {"stats": st, "grads": [g.numpy() for g in
                                           tree_leaves(grads)]}
    return out


def _port_restore_rank(world, params, ckpt_dir):
    """Restore JAX's stage = 2 checkpoint on a 2 x 1 grid and finish."""
    from repro_torch.ft.checkpoint import CheckpointManager
    edges, feats = make_stream()
    pipe = _port_pipe(make_stream_mesh(world.device, stage=2), params,
                      **cfg_kw("streaming"))
    step = CheckpointManager(ckpt_dir).restore_pipeline(pipe)
    return {"step": step, "in_flight": pipe._ring_occupancy_host(),
            "emb": ckpt_finish(pipe, edges, feats, len(edges) // 2)}


# ------------------------------------------------------------- JAX side

def jax_reference(path, port_ckpt, jax_ckpt):
    """Every case through the JAX D3Pipeline on a forced 4-device mesh;
    the port's checkpoint restores last, once its rank 0 has written it."""
    import jax
    from repro.core import windowing as jwin
    from repro.core.pipeline import D3Pipeline as JaxPipeline
    from repro.core.pipeline import PipelineConfig as JaxConfig
    from repro.core.train_plane import TrainConfig as JaxTrainConfig
    from repro.ft.checkpoint import CheckpointManager as JaxManager
    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro.launch.mesh import make_stream_mesh as jax_mesh
    from repro.optim import sgd as jsgd

    meshes = {1: jax_mesh(2, stage=2), 2: jax_mesh(4, stage=2)}

    def build(n_data, n_layers=2, train=None, **kw):
        kind, interval = kw.pop("window")
        model = JaxSAGE((D,) * (n_layers + 1),
                        n_classes=N_CLS if train is not None else 0)
        params = model.init(jax.random.key(0))
        cfg = JaxConfig(**kw, window=jwin.WindowConfig(kind=kind,
                                                       interval=interval))
        return JaxPipeline(model, params, cfg, mesh=meshes[n_data],
                           train=train)

    out = {}
    for name, (n_data, _, window, n_layers, cap, hub) in CASES.items():
        edges, feats = hub_stream() if hub else make_stream()
        pipe = build(n_data, n_layers, **cfg_kw(window, cap))
        res = drive(pipe, name, edges, feats)
        res["agg_cnt"] = [np.asarray(ls.agg_cnt) for ls in pipe.states]
        res["ring"] = tuple(pipe.stage_ring.shape)
        out[name] = res
    out["query"] = query_run(build(1, **cfg_kw("streaming", query_cap=8)))
    pipe = build(2, train=JaxTrainConfig(optimizer=jsgd(), lr=0.0,
                                         batch_threshold=1), train_cap=64,
                 **cfg_kw("streaming"))
    st, grads = train_run(pipe)
    out["train"] = {"stats": st, "grads": [np.asarray(g) for g in
                                           jax.tree.leaves(grads)]}
    # the JAX checkpoint, cut as the port cuts its own
    edges, feats = make_stream()
    half = len(edges) // 2
    pipe = build(1, **cfg_kw("streaming"))
    pipe.run_stream(edges[:half], feats, tick_edges=24)
    JaxManager(jax_ckpt).save_pipeline(0, pipe)
    out["ckpt"] = {"straight": ckpt_finish(pipe, edges, feats, half)}
    # the port's checkpoint, restored into a fresh JAX 2 x 1 pipeline
    deadline = time.monotonic() + TIMEOUT
    while not (Path(port_ckpt) / "written").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the port's checkpoint never appeared")
        time.sleep(0.2)
    fresh = build(1, **cfg_kw("streaming"))
    out["ckpt"]["step"] = JaxManager(port_ckpt).restore_pipeline(fresh)
    out["ckpt"]["in_flight"] = fresh._ring_occupancy_host()
    out["ckpt"]["restored"] = ckpt_finish(fresh, edges, feats, half)
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX summaries, the port's per-rank results, params), computed side
    by side: the forced-4 JAX subprocess starts first."""
    import jax

    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro_torch.convert import params_from_numpy
    tmp = tmp_path_factory.mktemp("stage")
    out, port_ckpt, jax_ckpt = tmp / "ref.pkl", tmp / "port", tmp / "jax"
    port_ckpt.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS} "
                         "--xla_backend_optimization_level=0 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(out), str(port_ckpt),
         str(jax_ckpt)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        conv = lambda model: params_from_numpy(jax.tree.map(
            np.asarray, model.init(jax.random.key(0))))
        params = conv(JaxSAGE((D, D, D)))
        params4 = conv(JaxSAGE((D,) * 5))
        tparams = conv(JaxSAGE((D, D, D), n_classes=N_CLS))
        port = spawn_stream_mesh(N_RANKS, _port_rank, backend="gloo",
                                 device="cpu", timeout=TIMEOUT,
                                 args=(params, params4, tparams,
                                       str(port_ckpt)))
        log, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return ref, port, params, params4, str(jax_ckpt)


def _oracle(params, edges, feats, n_layers=2):
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    model = GraphSAGE((D,) * (n_layers + 1))
    model.load_state_dict(params)
    g, _ = build_snapshot(edges, feats, D, N_NODES, "cpu")
    return oracle_embeddings(model, g).numpy()


def _emb_close(got, want, tol=1e-5):
    assert set(got) == set(want) and got
    for vid, vec in want.items():
        np.testing.assert_allclose(got[vid], vec, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_stage_grid_matches_jax(runs, name):
    """Every call's integer stats, the metrics (stage_idle included), the
    busy vector and the aggregator counts equal JAX's; the ring holds
    rows after the stream and none after the flush; embeddings within
    1e-5 of JAX's and the sink within 1e-4 of the oracle."""
    ref, port, params, params4, _ = runs
    want = ref[name]
    n_data, _, _, n_layers, cap, hub = CASES[name]
    ranks = [p[name] for p in port if name in p]
    assert len(ranks) == 2 * n_data
    for r in ranks:
        assert r["stats"] == want["stats"]
        assert r["metrics"] == want["metrics"]
        np.testing.assert_array_equal(r["busy"], want["busy"])
        assert r["in_flight"] == want["in_flight"]
        assert r["left"] == want["left"] == 0
        assert r["bubble"] == want["bubble"] and 0 < r["bubble"] <= 1
        _emb_close(r["emb"], want["emb"])
    # the ranks' blocks, stacked as the reference's [S, P, N] rounds
    for rd in range(n_layers // 2):
        got = np.stack([np.concatenate([ranks[s * n_data + d]["agg_cnt"][rd]
                                        for d in range(n_data)])
                        for s in range(2)])
        np.testing.assert_array_equal(got, want["agg_cnt"][rd])
    C = want["ring"][2] // n_data
    assert ranks[0]["ring"] == (n_layers // 2, C, D + 3)
    m = want["metrics"]
    assert m["route_dropped"] == 0 and m["stage_idle"] > 0
    if "streaming" in name:
        assert want["in_flight"] > 0, \
            "a just-streamed pipeline must have rows in flight"
    if cap is not None:
        assert m["route_deferred"] > 0, "an 8-row bucket must defer"
    edges, feats = hub_stream() if hub else make_stream()
    oracle = _oracle(params4 if n_layers == 4 else params, edges, feats,
                     n_layers)
    for vid, vec in ranks[0]["emb"].items():
        np.testing.assert_allclose(vec, oracle[vid], rtol=1e-4, atol=1e-4)


def test_stage_query_plane_matches_jax(runs):
    """Point queries from the stage-replicated sink: the answers equal
    JAX's (qid, kind, ok, tick exactly; vec and score within 1e-5),
    stale_ok reads equal read_nodes, nothing strands."""
    ref, port, *_ = runs
    want = ref["query"]
    for r in (p["query"] for p in port if "query" in p):
        got, exp = r["answers"], want["answers"]
        assert got["qid"].tolist() == list(range(5)) and got["ok"].all()
        for k in ("qid", "kind", "ok", "tick", "issue"):
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
        np.testing.assert_allclose(got["vec"], exp["vec"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["score"], exp["score"], rtol=1e-4,
                                   atol=1e-5)
        for qid, v in enumerate(r["vids"]):
            np.testing.assert_array_equal(got["vec"][qid], r["snap"][v])
        assert r["metrics"] == want["metrics"]


def test_stage_checkpoint_round_trip_both_packages(runs):
    """A stage = 2 cut mid-stream carries the ring's in-flight rows: the
    port's checkpoint restores into fresh port ranks and into JAX, JAX's
    into the port; every continuation converges to the writer's
    uninterrupted run."""
    ref, port, params, _, jax_ckpt = runs
    mine = [p["ckpt"] for p in port if "ckpt" in p]
    assert len(mine) == 2
    for r in mine:
        assert r["in_flight"] == r["restored_in_flight"] > 0
        _emb_close(r["restored"], r["straight"], 1e-6)
    want = ref["ckpt"]
    assert want["step"] == 0 and want["in_flight"] == mine[0]["in_flight"]
    _emb_close(want["restored"], mine[0]["straight"])
    _emb_close(mine[0]["straight"], want["straight"])
    back = spawn_stream_mesh(2, _port_restore_rank, backend="gloo",
                             device="cpu", args=(params, jax_ckpt),
                             timeout=TIMEOUT)
    for r in back:
        assert r["step"] == 0 and r["in_flight"] == mine[0]["in_flight"]
        _emb_close(r["emb"], want["straight"])


def test_stage_training_matches_jax(runs):
    """The training plane at 2 x 2 (stage-replicated TrainState, every
    stage running the full-L backward over the stage-gathered caches):
    one fire, loss and every last_grad leaf within rtol 1e-5 of JAX's."""
    ref, port, *_ = runs
    want = ref["train"]
    for r in (p["train"] for p in port):
        assert r["stats"]["steps"] == want["stats"]["steps"] == 1
        np.testing.assert_allclose(r["stats"]["loss"], want["stats"]["loss"],
                                   rtol=1e-5, atol=1e-6)
        assert len(r["grads"]) == len(want["grads"])
        for a, b in zip(r["grads"], want["grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert [p["grid"] for p in port] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_stage_config_refusals_match_jax():
    """The stage checks of validate, and the uniform-stack contract: the
    same ValueErrors as the reference's."""
    from repro.core.pipeline import PipelineConfig as JaxConfig
    for cls in (JaxConfig, PipelineConfig):
        with pytest.raises(ValueError, match="must be >= 1"):
            cls(n_stages=0).validate()
        with pytest.raises(ValueError, match="LocalRouter"):
            cls(n_stages=2).validate(n_devices=2, n_layers=2, local=True)
        with pytest.raises(ValueError, match="multiple of the stage count"):
            cls(n_stages=2).validate(n_devices=3, n_layers=2)
        with pytest.raises(ValueError, match="round-robin"):
            cls(n_stages=2).validate(n_devices=4, n_layers=3)
        cls(n_parts=4, feat_cap=4).validate(n_devices=1)
        cls(n_parts=4, feat_cap=4, n_stages=2).validate(n_devices=4,
                                                        n_layers=2)


def _refusal_rank(world):
    out = {}
    mesh = make_stream_mesh(world.device, stage=2)
    for key, model, n_stages in (("mismatch", GraphSAGE((D, D, D)), 1),
                                 ("uniform", GraphSAGE((D, 16, D)), 2)):
        try:
            D3Pipeline(model, _port_cfg(**dict(cfg_kw("streaming"),
                                               n_stages=n_stages)),
                       mesh=mesh)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def test_stage_mesh_refusals():
    """A mesh whose stage count differs from the config's, and a layer
    stack that is not SPMD-uniform, raise ValueError on every rank."""
    for r in spawn_stream_mesh(2, _refusal_rank, backend="gloo",
                               device="cpu", stage=2, timeout=TIMEOUT):
        assert "must agree" in r["mismatch"]
        assert "SPMD-uniform" in r["uniform"]


if __name__ == "__main__":
    jax_reference(*sys.argv[1:])
