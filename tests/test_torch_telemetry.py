"""The port's telemetry plane against the JAX package's, on the CPU.

The same numpy streams and JAX-initialised weights go through both
packages (tests/test_telemetry.py's sizes: 32 nodes, dims (8, 12, 12), 4
parts):

  * occupancy rows: every device column and every integer host column of
    the trace equal JAX's, all four window policies, both drivers; with
    telemetry off the TickStats gauges are zeros, and every other stat of
    every call, the sink and the state are bit-equal to the telemetry-on
    run (telemetry observes and changes nothing);
  * the query-plane and training-plane gauges equal JAX's;
  * the trace recorder's round trip and schema refusal, and trace
    interchange: each package loads the other's .npz;
  * the defer-occupancy helper;
  * the cost model: the synthetic coefficients recovered and equal to
    JAX's fit, the compile-spike mask, `what_if` at link_bw = 50e9 equal
    to JAX's (which prices at its built-in 50e9);
  * the advisor: recommendations equal to JAX's for the same stream, the
    zero-drop replay through the port, and the CLI's JSON equal to JAX's
    CLI for the same trace;
  * the serving percentiles stamped into the trace meta.

Integers are compared exactly; cost-model and advisor numbers to 1e-12
relative (the same numpy arithmetic); the replayed sink bit for bit.
The 4-rank mesh case runs in tests/test_torch_mesh.py.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import windowing as jwin
from repro.core.pipeline import D3Pipeline as JaxPipeline
from repro.core.pipeline import PipelineConfig as JaxConfig
from repro.graph.sage import GraphSAGE as JaxSAGE
from repro.telemetry import advisor as jadv
from repro.telemetry import cost_model as jcm
from repro.telemetry import trace as jtr
from repro_torch.convert import params_from_numpy
from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.core.tick import SCALAR_FIELDS
from repro_torch.graph.sage import GraphSAGE
from repro_torch.telemetry import advisor as tadv
from repro_torch.telemetry import cost_model as tcm
from repro_torch.telemetry.trace import (TRACE_DEVICE_COLS, TRACE_HOST_COLS,
                                         Trace, TraceRecorder, load_trace)

N_NODES, D_IN, DIMS = 32, 8, (8, 12, 12)
CAPS = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES)
POLICIES = ["streaming", "tumbling", "session", "adaptive"]
FLUSH_TICKS = 8
GAUGES = ("occ_bc_defer", "occ_rmi_defer", "route_peak", "outbox_part_peak")
INT_HOST_COLS = [c for c in TRACE_HOST_COLS if c not in ("wall_s", "host_s")]


def make_stream(seed=0, n_edges=100):
    """test_telemetry.make_stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


@pytest.fixture(scope="module")
def jparams():
    return JaxSAGE(DIMS).init(jax.random.key(0))


def jax_pipe(jparams, kind="streaming", **kw):
    return JaxPipeline(JaxSAGE(DIMS), jparams, JaxConfig(
        **dict(CAPS, **kw), window=jwin.WindowConfig(kind=kind,
                                                     interval=3)))


def port_pipe(jparams, kind="streaming", **kw):
    model = GraphSAGE(DIMS)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray,
                                                         jparams)))
    return D3Pipeline(model, PipelineConfig(
        **dict(CAPS, **kw), window=win.WindowConfig(kind=kind, interval=3)),
        device="cpu")


def drive(pipe, e_chunks, f_chunks, driver):
    """test_telemetry.drive: the chunks then FLUSH_TICKS empty ticks.
    Returns every call's stats."""
    if driver == "tick":
        out = [pipe.tick(e, f) for e, f in zip(e_chunks, f_chunks)]
        return out + [pipe.tick() for _ in range(FLUSH_TICKS)]
    return [pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks))[0],
            pipe.run_super_tick(T=FLUSH_TICKS)[0]]


def assert_trace_equal(got: dict, want: dict):
    for c in TRACE_DEVICE_COLS + INT_HOST_COLS:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


# ------------------------------------------------------ occupancy rows

@pytest.mark.parametrize("driver", ["tick", "super"])
@pytest.mark.parametrize("kind", POLICIES)
def test_occupancy_rows_equal_jax(jparams, kind, driver):
    edges, feats = make_stream()
    jp = jax_pipe(jparams, kind, telemetry=True)
    e_chunks, f_chunks = jp.chunk_stream(edges, feats, 24)
    drive(jp, e_chunks, f_chunks, driver)
    on, off = (port_pipe(jparams, kind, telemetry=t) for t in (True, False))
    s_on = drive(on, e_chunks, f_chunks, driver)
    s_off = drive(off, e_chunks, f_chunks, driver)
    cols = on.trace.columns()
    assert len(on.trace) == len(jp.trace) == len(e_chunks) + FLUSH_TICKS
    assert_trace_equal(cols, jp.trace.columns())
    assert (cols["wall_s"] > 0).all()
    assert cols["amortized"].all() == (driver == "super")
    assert off.trace is None and off.straggler is None
    # the folded peaks and the straggler feed as JAX's
    for k in ("route_peak", "outbox_peak", "outbox_part_peak",
              "occ_defer_ticks"):
        assert getattr(on.metrics, k) == getattr(jp.metrics, k), k
    assert on.straggler.ticks_observed == jp.straggler.ticks_observed
    # telemetry observes and changes nothing: every other stat of every
    # call, the sink and the state bit-equal to the run without it
    for a, b in zip(s_on, s_off):
        for sa, sb in zip(a, b):
            for f in SCALAR_FIELDS:
                if f in GAUGES:
                    assert int(getattr(sb, f)) == 0, f
                else:
                    assert int(getattr(sa, f)) == int(getattr(sb, f)), f
            assert torch.equal(sa.busy, sb.busy)
    assert torch.equal(on.sink, off.sink)
    for la, lb in zip(on.states, off.states):
        for f in la.__dataclass_fields__:
            assert torch.equal(getattr(la, f), getattr(lb, f)), f


def test_query_plane_gauges_equal_jax(jparams):
    """test_telemetry.test_query_plane_occupancy_gauges, both packages:
    query_pending equals the held-slot population after each tick."""
    from repro_torch.serve.query import KIND_EMBED
    edges, feats = make_stream()
    u = int(edges[0, 0])
    q = [(1, KIND_EMBED, u, True), (2, KIND_EMBED, u, False)]
    pipes = [jax_pipe(jparams, telemetry=True, query_cap=8),
             port_pipe(jparams, telemetry=True, query_cap=8)]
    for p in pipes:
        p.run_stream(edges[:48], feats, tick_edges=24)
        p.tick(edges[48:72], queries=q)
    base = 2
    held = int(pipes[1].queries.pending.sum())
    cols = pipes[1].trace.columns()
    assert cols["query_pending"][base] == held
    assert cols["q_admitted"][base] == 2 and cols["queries_in"][base] == 2
    for p in pipes:
        p.flush(max_ticks=64)
    cols = pipes[1].trace.columns()
    assert cols["q_answered"].sum() == 2 and cols["query_pending"][-1] == 0
    assert_trace_equal(cols, pipes[0].trace.columns())


def test_training_plane_gauges_equal_jax():
    """train_labeled / train_dirty against JAX's online plane (the
    training tables' populations after each tick)."""
    from repro import optim as jopt
    from repro.core.train_plane import TrainConfig as JaxTrainConfig
    from repro_torch import optim as topt
    from repro_torch.core.train_plane import TrainConfig
    edges, feats = make_stream()
    jm = JaxSAGE(DIMS, n_classes=4)
    jparams = jm.init(jax.random.key(0))
    jp = JaxPipeline(jm, jparams, JaxConfig(
        **CAPS, train_cap=32, telemetry=True,
        window=jwin.WindowConfig(kind=jwin.STREAMING)),
        train=JaxTrainConfig(optimizer=jopt.sgd(), lr=0.05,
                             batch_threshold=6))
    model = GraphSAGE(DIMS, n_classes=4)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray,
                                                         jparams)))
    tp = D3Pipeline(model, PipelineConfig(
        **CAPS, train_cap=32, telemetry=True,
        window=win.WindowConfig(kind=win.STREAMING)), device="cpu",
        train=TrainConfig(optimizer=topt.sgd(), lr=0.05, batch_threshold=6))
    e_chunks, f_chunks = jp.chunk_stream(edges, feats, 24)
    labels = [[(int(v), int(v) % 4) for v in np.unique(e)[:5]]
              for e in e_chunks]
    for p in (jp, tp):
        for e, f, lab in zip(e_chunks, f_chunks, labels):
            p.tick(e, f, labels=lab)
        p.run_super_tick(T=4, label_chunks=[labels[0]])
    cols = tp.trace.columns()
    assert cols["train_labeled"].max() > 0 and cols["labels_in"].sum() > 0
    assert_trace_equal(cols, jp.trace.columns())
    assert tp.train_stats()["steps"] == int(jp.train_stats()["steps"]) > 0


# --------------------------------------------- trace recorder & loader

def test_trace_roundtrip_schema_and_validation(tmp_path):
    rec = TraceRecorder(meta={"n_parts": 4})
    assert rec.meta["schema"] == 1
    row = np.arange(len(TRACE_DEVICE_COLS))
    rec.append({"tick": 0, "wall_s": 0.25, "edges_in": 7}, row)
    rec.append({"tick": 1, "wall_s": 0.5}, row * 2)
    rec.annotate(serving_p99_ms=3.5)
    with pytest.raises(ValueError, match="columns"):
        rec.append({"tick": 2}, np.zeros(3))
    p = tmp_path / "trace.npz"
    rec.save(p)
    tr = load_trace(p)
    assert len(tr) == 2
    assert tr.meta["n_parts"] == 4 and tr.meta["serving_p99_ms"] == 3.5
    np.testing.assert_array_equal(tr.col("route_peak"),
                                  [row[11], 2 * row[11]])
    np.testing.assert_allclose(tr.col("wall_s"), [0.25, 0.5])
    assert tr.col("edges_in")[0] == 7 and tr.col("edges_in")[1] == 0
    assert set(tr.columns) == set(TRACE_HOST_COLS + TRACE_DEVICE_COLS)
    rec.meta["schema"] = 99
    rec.save(p)
    with pytest.raises(ValueError, match="schema"):
        load_trace(p)
    np.savez(tmp_path / "junk.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="meta"):
        load_trace(tmp_path / "junk.npz")
    assert TRACE_DEVICE_COLS == jtr.TRACE_DEVICE_COLS
    assert TRACE_HOST_COLS == jtr.TRACE_HOST_COLS


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_interchange(jparams, tmp_path, writer):
    """A trace one package saves loads through the other's load_trace
    with the same columns, dtypes and meta."""
    edges, feats = make_stream()
    pipe = (port_pipe if writer == "port" else jax_pipe)(
        jparams, "session", telemetry=True)
    pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
    pipe.save_trace(tmp_path / "t.npz")
    own = (load_trace if writer == "port" else jtr.load_trace)(
        tmp_path / "t.npz")
    other = (jtr.load_trace if writer == "port" else load_trace)(
        tmp_path / "t.npz")
    assert other.meta == own.meta and len(other) == len(own) > 0
    for c in TRACE_HOST_COLS + TRACE_DEVICE_COLS:
        assert other.col(c).dtype == own.col(c).dtype, c
        np.testing.assert_array_equal(other.col(c), own.col(c), err_msg=c)


def test_defer_occupancy_helper_equals_jax():
    from dataclasses import replace
    from repro.core.state import defer_occupancy as jocc
    from repro.core.state import init_layer as jinit
    from repro_torch.core.state import defer_occupancy, init_layer
    bc = np.array([1, 0, 1, 1, 0, 0], bool)
    rmi = np.array([0, 1, 0, 0], bool)
    ls = init_layer(4, 8, D_IN, D_IN, "cpu", bc_defer_rows=6,
                    rmi_defer_rows=4)
    assert tuple(int(x) for x in defer_occupancy(ls)) == (0, 0)
    ls = replace(ls, bc_defer_ok=torch.as_tensor(bc),
                 rmi_defer_ok=torch.as_tensor(rmi))
    jls = replace(jinit(4, 8, D_IN, D_IN, bc_defer_rows=6,
                        rmi_defer_rows=4),
                  bc_defer_ok=jax.numpy.asarray(bc),
                  rmi_defer_ok=jax.numpy.asarray(rmi))
    assert tuple(int(x) for x in defer_occupancy(ls)) == \
        tuple(int(x) for x in jocc(jls)) == (3, 1)


# ------------------------------------------------------------ cost model

def _synthetic_trace(cls=Trace, T=64, seed=0, c0=2e-3):
    """test_telemetry._synthetic_trace, as either package's Trace."""
    rng = np.random.default_rng(seed)
    cols = {c: np.zeros(T, np.int64)
            for c in TRACE_HOST_COLS + TRACE_DEVICE_COLS}
    cols["tick"] = np.arange(T)
    cols["ticks"] = np.ones(T, np.int64)
    cols["amortized"] = np.ones(T, np.int64)
    cols["emitted_sum"] = rng.integers(0, 200, T)
    cols["wire_rows"] = rng.integers(0, 400, T)
    cols["reduce_msgs"] = rng.integers(0, 300, T)
    cols["edges_in"] = rng.integers(0, 64, T)
    per_row = {"compute_rows": 4e-6, "wire_rows": 1e-6,
               "deliver_rows": 2e-6, "ingest_rows": 8e-6}
    wall = np.full(T, c0)
    wall += per_row["compute_rows"] * cols["emitted_sum"]
    wall += per_row["wire_rows"] * cols["wire_rows"]
    wall += per_row["deliver_rows"] * cols["reduce_msgs"]
    wall += per_row["ingest_rows"] * cols["edges_in"]
    cols["wall_s"] = wall
    meta = {"schema": 1, "n_parts": 4, "n_devices": 4, "n_stages": 1,
            "route_cap": None, "wire_lanes": [[100, 13], [160, 13]],
            "a2a_mult": 64, "fixed_wire_bytes": 1000,
            "wire_bytes_per_tick": 1000 + 64 * (100 + 160) * 13}
    cols = {k: np.asarray(v, np.float64 if k in ("wall_s", "host_s")
                          else np.int64) for k, v in cols.items()}
    return cls(meta, cols)


def _close(a, b, rel=1e-12):
    assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-300), (a, b)


def test_cost_model_recovers_synthetic_coefficients_as_jax():
    tr = _synthetic_trace()
    cm = tcm.fit_cost_model(tr)
    jm = jcm.fit_cost_model(_synthetic_trace(jtr.Trace))
    assert abs(cm.intercept - 2e-3) < 1e-7
    for k, want in (("compute_rows", 4e-6), ("wire_rows", 1e-6),
                    ("deliver_rows", 2e-6), ("ingest_rows", 8e-6)):
        assert abs(cm.coef[k] - want) < 1e-9, k
    assert cm.coef["query_rows"] == 0.0 and cm.coef["train_rows"] == 0.0
    _close(cm.intercept, jm.intercept)
    for k in tcm.FEATURES:
        _close(cm.coef[k], jm.coef[k])
    assert list(tcm.FEATURES) == list(jcm.FEATURES)
    rep, jrep = cm.report(tr, tol=0.25), jm.report(tr, tol=0.25)
    assert rep["n"] == len(tr) and rep["hit_frac"] == 1.0
    assert rep["n"] == jrep["n"] and rep["hit_frac"] == jrep["hit_frac"]
    _close(rep["mae_frac"], jrep["mae_frac"])
    cm2 = tcm.CostModel.from_dict(json.loads(json.dumps(cm.to_dict())))
    np.testing.assert_allclose(cm2.predict(tr.columns),
                               cm.predict(tr.columns), rtol=1e-12)
    with pytest.raises(ValueError, match="schema"):
        tcm.CostModel.from_dict({"schema": 0, "intercept": 0, "coef": {}})


def test_cost_model_what_if_at_a_given_link_rate_equals_jax():
    """The port prices the wire delta at the caller's link_bw; at 50e9
    (the reference's constant) it equals JAX's what_if."""
    tr = _synthetic_trace()
    cm = tcm.fit_cost_model(tr)
    jm = jcm.fit_cost_model(_synthetic_trace(jtr.Trace))
    assert cm.wire_bytes_at() == tr.meta["wire_bytes_per_tick"]
    assert cm.wire_bytes_at(route_cap=8) == 1000 + 64 * (8 + 8) * 13
    assert cm.wire_bytes_at(n_devices=8) == \
        2 * 1000 + 4 * 64 * (100 + 160) * 13
    for kw in (dict(route_cap=8), dict(n_devices=8), dict(route_cap=300),
               dict(n_stages=2)):
        got = cm.what_if(tr, **kw, link_bw=50e9)
        want = jm.what_if(tr, **kw)
        assert got["wire_bytes_per_tick"] == want["wire_bytes_per_tick"]
        assert got["wire_bytes_delta"] == want["wire_bytes_delta"]
        _close(got["pred_tick_s"], want["pred_tick_s"])
        _close(got["wire_delta_s"], want["wire_delta_s"])
    # the rate is the caller's: no default, and halving it doubles the
    # wire term
    with pytest.raises(TypeError):
        cm.what_if(tr, route_cap=8)
    with pytest.raises(ValueError, match="link_bw"):
        cm.what_if(tr, route_cap=8, link_bw=0.0)
    _close(cm.what_if(tr, route_cap=8, link_bw=25e9)["wire_delta_s"],
           2 * cm.what_if(tr, route_cap=8, link_bw=50e9)["wire_delta_s"])


def test_cost_model_masks_compile_spikes_as_jax():
    tr = _synthetic_trace()
    cols = {k: v.copy() for k, v in tr.columns.items()}
    cols["wall_s"][0] = 50.0          # a one-time set-up spike
    spiked = Trace(tr.meta, cols)
    cm = tcm.fit_cost_model(spiked)
    jm = jcm.fit_cost_model(jtr.Trace(tr.meta, cols))
    assert abs(cm.intercept - 2e-3) < 1e-6
    _close(cm.intercept, jm.intercept)
    rep = cm.report(spiked, tol=0.25)
    assert rep["n"] == len(spiked) - 1 and rep["hit_frac"] == 1.0


# --------------------------------------------------------------- advisor

def test_advisor_recommends_as_jax_and_replays_clean(jparams, tmp_path):
    """Record -> recommend -> replay: the port's trace gives JAX's
    recommendations for the same stream (read by either package's
    advisor), and the port replays them with zero drops and the same
    sink."""
    edges, feats = make_stream(n_edges=160)
    pipes = {"port": port_pipe(jparams, telemetry=True),
             "jax": jax_pipe(jparams, telemetry=True)}
    for name, p in pipes.items():
        p.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        p.flush_super(max_ticks=64, T=4)
        p.save_trace(tmp_path / f"{name}.npz")
    trace = load_trace(tmp_path / "port.npz")
    recs = tadv.recommend(trace)
    assert recs == jadv.recommend(jtr.load_trace(tmp_path / "jax.npz"))
    assert recs == jadv.recommend(jtr.load_trace(tmp_path / "port.npz"))
    caps = recs["caps"]
    assert caps["outbox_cap"] % 4 == 0
    assert caps["outbox_cap"] >= 4 * trace.col("outbox_part_peak").max()
    assert caps["route_cap"] is None
    cfg2 = tadv.apply_recommendation(
        PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                       max_nodes=N_NODES), recs)
    cfg2.validate()
    model = GraphSAGE(DIMS)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray,
                                                         jparams)))
    replay = D3Pipeline(model, cfg2, device="cpu")
    replay.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
    replay.flush_super(max_ticks=64, T=4)
    out = tadv.replay_ok(replay)
    assert out["dropped"] == 0 and out["route_dropped"] == 0
    assert torch.equal(replay.sink, pipes["port"].sink)


@pytest.mark.parametrize("args", [[], ["--slack", "1.5"],
                                  ["--defer-budget", "0.25"]])
def test_advisor_cli_prints_jax_json(jparams, tmp_path, capsys, args):
    """Both CLIs on one trace give the same JSON, on stdout and --out."""
    edges, feats = make_stream(n_edges=80)
    pipe = port_pipe(jparams, telemetry=True)
    pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
    path = str(tmp_path / "TRACE.npz")
    pipe.save_trace(path)
    assert tadv.main([path] + args) == 0
    port_out = capsys.readouterr().out
    assert jadv.main([path] + args) == 0
    assert port_out == capsys.readouterr().out
    assert tadv.main([path, "--out", str(tmp_path / "p.json")] + args) == 0
    assert jadv.main([path, "--out", str(tmp_path / "j.json")] + args) == 0
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    recs = json.loads(port_out)
    assert recs["schema"] == 1 and recs["caps"]["outbox_cap"] >= 4


def test_serving_percentiles_ride_the_trace_meta(jparams):
    from repro_torch.serve.session import ServeSession
    edges, feats = make_stream()
    pipe = port_pipe(jparams, telemetry=True, query_cap=8)
    sess = ServeSession(pipe, driver="super", super_ticks=4)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    sess.advance_super(e_chunks, f_chunks)
    sess.submit_embed([int(edges[0, 0]), int(edges[0, 1])])
    sess.advance_super(T=4)
    sess.flush()
    st = sess.latency_stats()
    meta = pipe.trace.meta
    assert meta["serving_p99_ms"] == st["p99_ms"] > 0
    assert meta["serving_p50_ms"] == st["p50_ms"]
    assert meta["serving_answered"] == st["answered"] == 2
