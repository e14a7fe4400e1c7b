"""The port's D3Pipeline (per-tick and super-tick drivers) against the JAX
D3Pipeline (delivery_backend="xla") on a small stream, for all four
window policies, plus the serve CLI's pinned counts.

Tolerances: StreamMetrics counters, the busy vector and aggregator counts
exactly equal; sink embeddings within 1e-5 of the JAX run (absolute and
relative) and within 1e-4 of the port's static oracle (core/oracle.py, the
bound examples/quickstart.py uses). The JAX xla backend is the reference
here; the integer stats do not depend on its backend.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import windowing as jwin
from repro.core.pipeline import D3Pipeline as JaxPipeline
from repro.core.pipeline import PipelineConfig as JaxConfig
from repro.graph.sage import GraphSAGE as JaxSAGE
from repro_torch.convert import params_from_numpy
from repro_torch.core import windowing as twin
from repro_torch.core.oracle import build_snapshot, oracle_embeddings
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.graph.sage import GraphSAGE
from repro_torch.launch import serve

N_NODES, D_IN, DIMS = 40, 8, (8, 12, 12)
POLICIES = ["streaming", "tumbling", "session", "adaptive"]
CAPS = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES)


def _window(kind, mod):
    return mod.WindowConfig(kind=kind, interval=3)


def _stream():
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, N_NODES, 150),
                      rng.integers(0, N_NODES, 150)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def _drive(pipe, driver, edges, feats):
    if driver == "super":
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        pipe.flush_super(max_ticks=96, T=4)
    else:
        pipe.run_stream(edges, feats, tick_edges=24)
        pipe.flush(max_ticks=96)
    return pipe


def _port_model(jparams):
    model = GraphSAGE(DIMS)
    model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    return model


@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_pipeline_matches_jax_and_oracle(driver, kind):
    edges, feats = _stream()
    jmodel = JaxSAGE(DIMS)
    jparams = jmodel.init(jax.random.key(0))
    ref = _drive(JaxPipeline(jmodel, jparams, JaxConfig(
        **CAPS, window=_window(kind, jwin))), driver, edges, feats)
    model = _port_model(jparams)
    for backend in ("kernel", "scatter"):
        pipe = _drive(D3Pipeline(model, PipelineConfig(
            **CAPS, window=_window(kind, twin), delivery_backend=backend),
            device="cpu"), driver, edges, feats)
        for name in ("ticks", "reduce_msgs", "broadcast_msgs",
                     "cross_part_msgs", "emitted_total", "dropped"):
            assert getattr(pipe.metrics, name) == \
                getattr(ref.metrics, name), name
        np.testing.assert_array_equal(pipe.metrics.busy_logical,
                                      ref.metrics.busy_logical)
        for li in range(len(DIMS) - 1):
            np.testing.assert_array_equal(
                pipe.states[li].agg_cnt.numpy(),
                np.asarray(ref.states[li].agg_cnt))
        want, got = ref.embeddings(), pipe.embeddings()
        assert set(got) == set(want) and len(got) > 0
        for vid in want:
            np.testing.assert_allclose(got[vid], want[vid], rtol=1e-5,
                                       atol=1e-5)
    g, _ = build_snapshot(edges, feats, D_IN, N_NODES, "cpu")
    oracle = oracle_embeddings(model, g).numpy()
    for vid, vec in got.items():
        np.testing.assert_allclose(vec, oracle[vid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("driver,rmis,cross", [("tick", 3032, 2491),
                                               ("super", 3049, 2507)])
def test_serve_cli_pinned_counts(driver, rmis, cross, capsys):
    """The JAX serve CLI's pinned counts at --edges 1500 (both drivers
    materialize the same embeddings)."""
    pipe = serve.main(["--device", "cpu", "--edges", "1500",
                       "--driver", driver])
    assert (pipe.metrics.reduce_msgs, pipe.metrics.cross_part_msgs) == \
        (rmis, cross)
    assert len(pipe.embeddings()) == 185
    line = capsys.readouterr().out
    assert f"{rmis} RMIs, {cross} cross-part msgs" in line
    assert "materialized 185 embeddings" in line


def _serve_rank(mesh, argv):
    """One rank of the serve stream on a mesh: its metrics, read back."""
    pipe = serve.serve_stream(serve.parse_args(argv), mesh)
    out = {k: v for k, v in vars(pipe.metrics).items()
           if isinstance(v, int)}
    out["materialized"] = len(pipe.embeddings())
    return out


@pytest.mark.parametrize("driver,rmis,cross", [("tick", 3032, 2491),
                                               ("super", 3049, 2507)])
def test_serve_cli_mesh_pinned_counts(driver, rmis, cross):
    """The serve CLI's stream sharded over 4 gloo ranks (dense exchange,
    through serve_stream's mesh argument) keeps the pinned counts; every
    rank reads the same global metrics."""
    from repro_torch.launch.mesh import spawn_stream_mesh
    ranks = spawn_stream_mesh(
        4, _serve_rank, backend="gloo", device="cpu", timeout=300,
        args=(["--edges", "1500", "--driver", driver],))
    for r in ranks:
        assert (r["reduce_msgs"], r["cross_part_msgs"]) == (rmis, cross)
        assert r["materialized"] == 185
        assert r["route_deferred"] == r["route_dropped"] == 0
        assert r["wire_rows"] > 0 and r == ranks[0]


@pytest.mark.parametrize("field,value,item", [
    ("n_stages", 2, 13), ("delta_eps", 1e-3, 8),
    ("train_cap", 4, 10), ("telemetry", True, 11)])
def test_unported_planes_raise(field, value, item):
    """Every plane named here is ported now (items 8, 10, 11 and 13):
    delta_eps > 0 and telemetry=True run (one trace row a tick),
    train_cap > 0 without train= is the ValueError JAX raises, and
    n_stages = 2 without a mesh is the ValueError JAX raises (the
    LocalRouter has no stage axis); none raises NotImplementedError."""
    cfg = PipelineConfig(**CAPS, **{field: value})
    if item == 13:
        with pytest.raises(ValueError, match="LocalRouter"):
            JaxConfig(**CAPS, **{field: value}).validate(
                n_devices=1, n_layers=2, local=True)
        with pytest.raises(ValueError, match="LocalRouter"):
            D3Pipeline(GraphSAGE(DIMS), cfg, device="cpu")
        return
    if item in (8, 11):
        edges, feats = _stream()
        pipe = D3Pipeline(GraphSAGE(DIMS), cfg, device="cpu")
        pipe.run_stream(edges[:48], feats, tick_edges=24)
        assert pipe.metrics.ticks == 2
        if item == 11:
            assert len(pipe.trace) == 2
        return
    if item == 10:
        with pytest.raises(ValueError, match="train_cap"):
            D3Pipeline(GraphSAGE(DIMS), cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        D3Pipeline(GraphSAGE(DIMS), cfg, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("n_stages", 0), ("delta_eps", -1e-3), ("delta_eps", float("nan")),
    ("query_cap", -1), ("train_cap", -1)])
def test_bad_values_raise_value_error_as_jax_does(field, value):
    """A bad value is a ValueError in both packages, checked before the
    port asks whether the plane is ported."""
    with pytest.raises(ValueError, match=f"{field}="):
        JaxConfig(**CAPS, **{field: value}).validate()
    with pytest.raises(ValueError, match=f"{field}="):
        PipelineConfig(**CAPS, **{field: value}).validate()
    with pytest.raises(ValueError, match=f"{field}="):
        D3Pipeline(GraphSAGE(DIMS), PipelineConfig(**CAPS, **{field: value}),
                   device="cpu")


def test_route_cap_without_mesh_is_the_dense_path():
    """route_cap only caps a mesh's wire: on one device no ring exists and
    the run equals the uncapped one."""
    edges, feats = _stream()
    model = GraphSAGE(DIMS)
    a = _drive(D3Pipeline(model, PipelineConfig(**CAPS), device="cpu"),
               "tick", edges, feats)
    b = _drive(D3Pipeline(model, PipelineConfig(**CAPS, route_cap=2,
                                                route_defer_cap=3),
                          device="cpu"), "tick", edges, feats)
    assert b.states[0].rmi_defer.shape[0] == 0
    for name in ("ticks", "reduce_msgs", "broadcast_msgs", "emitted_total",
                 "wire_rows", "wire_bytes", "route_deferred"):
        assert getattr(b.metrics, name) == getattr(a.metrics, name), name
    assert a.metrics.wire_bytes == 0
    for x, y in zip(a.states, b.states):
        assert torch.equal(x.agg, y.agg) and torch.equal(x.agg_cnt, y.agg_cnt)


def _grid_rank(mesh):
    return (mesh.rank, mesh.stage_index, mesh.data_index, mesh.n_stages,
            mesh.n_data, mesh.member)


def test_unported_pipeline_arguments_raise():
    """The 2-D mesh launcher is ported: stage=2 over 4 ranks gives each
    rank its place on a 2 x 2 grid (rank r = s * D + d); a mesh without a
    process group, or a rank count that stage does not divide, raises."""
    from repro_torch.launch.mesh import make_stream_mesh, spawn_stream_mesh
    cfg = PipelineConfig(**CAPS)
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_stream_mesh(stage=2)
    with pytest.raises(ValueError, match="multiple of the stage count"):
        spawn_stream_mesh(3, _grid_rank, backend="gloo", device="cpu",
                          stage=2)
    grid = spawn_stream_mesh(4, _grid_rank, backend="gloo", device="cpu",
                             stage=2, timeout=120)
    assert grid == [(r, r // 2, r % 2, 2, 2, True) for r in range(4)]
    with pytest.raises(TypeError, match="StreamMesh"):
        D3Pipeline(GraphSAGE(DIMS), cfg, mesh=object(), device="cpu")
    # the training plane is ported: train= without train_cap is the
    # ValueError JAX raises
    with pytest.raises(ValueError, match="train_cap"):
        D3Pipeline(GraphSAGE(DIMS), cfg, train=object(), device="cpu")
    with pytest.raises(ValueError, match="not registered"):
        PipelineConfig(**CAPS, delivery_backend="xla").validate()


def test_super_driver_single_stats_sync_matches_tick_stats():
    """run_super_tick's summed stats equal the per-tick stats summed on the
    host, tick for tick, from identical pipelines."""
    edges, feats = _stream()
    model = GraphSAGE(DIMS)
    a = D3Pipeline(model, PipelineConfig(**CAPS), device="cpu")
    b = D3Pipeline(model, PipelineConfig(**CAPS), device="cpu")
    e_chunks, f_chunks = a.chunk_stream(edges, feats, 24)
    per_tick = [a.tick(e, f) for e, f in zip(e_chunks[:3], f_chunks[:3])]
    summed, _ = b.run_super_tick(e_chunks[:3], f_chunks[:3], T=3)
    for li in range(len(DIMS) - 1):
        assert int(summed[li].reduce_msgs) == sum(
            int(t[li].reduce_msgs) for t in per_tick)
        assert torch.equal(summed[li].busy,
                           sum(t[li].busy for t in per_tick))
    for x, y in zip(a.states, b.states):
        assert torch.equal(x.agg, y.agg) and torch.equal(x.feat, y.feat)
