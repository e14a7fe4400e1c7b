"""The port's live elastic reshard (`D3Pipeline.reshard`) against the JAX
package's, on the CPU.

Four gloo ranks (`launch/mesh.py:spawn_stream_mesh`, CPU tensors) form
the world every mesh of a case is carved from (`make_stream_mesh(ranks=)`,
`survivor_mesh`); a subprocess runs tests/test_chaos.py's reshard goldens
(`_run`) through the JAX D3Pipeline on a forced 4-device CPU mesh. Both
start together; the weights are JAX's, converted.

Cases, as test_chaos.py's: a mid-stream reshard 4 -> 2 and 2 -> 4 under
both drivers; to a local pipeline and onto survivors; a capped exchange
whose defer rings hold rows across the move; a 2-stage grid's data-axis
reshard (2 x 2 -> 2 x 1) under both drivers; and a stage-count change
refused while rows sit in the inter-stage ring, then allowed after the
flush.

Tolerances: the reference's own goldens hold in the port (an uncapped
1-D reshard leaves the flushed sink BIT-equal to the local run with
every logical stat equal; a capped or staged one within 1e-5), and the
port's sink is within 1e-5 of JAX's with every logical stat equal to
JAX's. Nothing is dropped.
"""
import os
import pickle
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.graph.sage import GraphSAGE
from repro_torch.launch.mesh import (make_stream_mesh, spawn_stream_mesh,
                                     survivor_mesh)

REPO = Path(__file__).resolve().parents[1]
N_RANKS, TIMEOUT = 4, 600
STAT_KEYS = ("ticks", "emitted_total", "reduce_msgs", "broadcast_msgs",
             "cross_part_msgs", "dropped", "route_dropped",
             "queries_admitted", "queries_answered", "suppressed")
# name: (driver, stages, old data shards, new mesh, PipelineConfig extras);
# the new mesh: a data-shard count (its ranks the world's first), "local"
# or "survivors" (data shards 1 and 3 lost)
CASES = {
    "down-tick": ("tick", 1, 4, 2, {}),
    "down-super": ("super", 1, 4, 2, {}),
    "up-tick": ("tick", 1, 2, 4, {}),
    "up-super": ("super", 1, 2, 4, {}),
    "to-local": ("tick", 1, 4, "local", {}),
    "survivors": ("tick", 1, 4, "survivors", {}),
    "capped": ("tick", 1, 4, 2, dict(route_cap=8, route_defer_cap=None)),
    "stage-data-tick": ("tick", 2, 2, 1, {}),
    "stage-data-super": ("super", 2, 2, 1, {}),
    "stage-uninterrupted-tick": ("tick", 2, 2, None, {}),
    "stage-uninterrupted-super": ("super", 2, 2, None, {}),
}


def _stream(n=32, d_in=8, n_events=150, seed=0):
    """test_chaos._stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, n_events),
                      rng.integers(0, n, n_events)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=d_in).astype(np.float32) for v in range(n)}
    return edges, feats


def _stats(pipe):
    m = asdict(pipe.metrics)
    return {k: m[k] for k in STAT_KEYS}


def _feed(pipe, edges, feats, driver, tick_edges=16):
    """test_chaos._feed (a rank the reshard removed feeds nothing)."""
    if not getattr(pipe, "active", True):
        return
    chunks = [edges[i:i + tick_edges]
              for i in range(0, len(edges), tick_edges)]
    rows = [[(int(v), feats[int(v)]) for e in c for v in set(map(int, e))]
            for c in chunks]
    if driver == "tick":
        for c, r in zip(chunks, rows):
            pipe.tick(c, r)
    else:
        pipe.run_super_tick(chunks, rows)


# ------------------------------------------------------------ port side

def _build(mesh, params, S=1, n=32, d_in=8, **cfg_kw):
    """test_chaos._build, the weights JAX's."""
    model = GraphSAGE((d_in, d_in, d_in))
    model.load_state_dict(params)
    cfg = PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                         feat_cap=128, edge_tick_cap=32, max_nodes=n,
                         n_stages=S,
                         window=win.WindowConfig(kind=win.SESSION,
                                                 interval=3), **cfg_kw)
    return D3Pipeline(model, cfg, mesh=mesh,
                      device=None if mesh is not None else "cpu")


def _run(mesh, params, edges, feats, driver, reshard, S=1, **cfg_kw):
    """test_chaos._run: half the stream, the reshard, the rest, the flush;
    (global sink, stats, data shards, local?) on the ranks that hold the
    pipeline at the end, None elsewhere."""
    pipe = _build(mesh, params, S=S, **cfg_kw)
    half = (len(edges) // 32) * 16          # chunk-aligned midpoint
    _feed(pipe, edges[:half], feats, driver)
    if reshard is not None:
        pipe.reshard(reshard())
    _feed(pipe, edges[half:], feats, driver)
    if not pipe.active:
        return None
    pipe.flush(max_ticks=128)
    return {"sink": pipe.sink_global().numpy(), "stats": _stats(pipe),
            "n_data": pipe._n_data, "local": pipe.mesh is None,
            "ring_rows": [int(ls.rmi_defer.shape[0]) for ls in pipe.states]}


def _port_rank(world, params):
    dev = world.device
    edges, feats = _stream()
    mk = lambda n, stage=1: make_stream_mesh(dev, stage=stage,
                                             ranks=range(n * stage))
    out = {}
    for name, (driver, S, old, new, kw) in CASES.items():
        mesh = mk(old, S)
        if new is None:
            target = None
        elif new == "local":
            target = lambda: None
        elif new == "survivors":
            target = lambda: survivor_mesh(mesh, [1, 3])
        else:
            target = lambda: mk(new, S)
        out[name] = _run(mesh, params, edges, feats, driver, target, S=S,
                         **kw)
    # a stage-count change waits for an empty inter-stage ring
    pipe = _build(mk(2, 2), params, S=2)
    _feed(pipe, edges[:96], feats, "tick")
    try:
        pipe.reshard(mk(4))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    pipe.flush(max_ticks=128)
    pipe.reshard(mk(4))
    _feed(pipe, edges[96:], feats, "tick")
    pipe.flush(max_ticks=128)
    out["quiescence"] = {"refused": refused, "stats": _stats(pipe),
                         "sink": pipe.sink_global().numpy()}
    return out


def _local_golden(params):
    edges, feats = _stream()
    return _run(None, params, edges, feats, "tick", None)


# ------------------------------------------------------------- JAX side

def jax_reference(path):
    """test_chaos.py's reshard goldens through the JAX package on a forced
    4-device mesh: the same cases, the same `_run`."""
    import jax
    sys.path.insert(0, str(REPO / "tests"))
    from repro.launch.mesh import make_stream_mesh as jax_mesh
    from repro.launch.mesh import survivor_mesh as jax_survivors
    from test_chaos import _build as jbuild
    from test_chaos import _feed as jfeed
    from test_chaos import _run as jrun
    from test_chaos import _stats as jstats

    edges, feats = _stream()
    out = {"local": jrun(None, edges, feats)[:2]}
    for name, (driver, S, old, new, kw) in CASES.items():
        if new is None:
            target = None
        elif new == "local":
            target = lambda: None
        elif new == "survivors":
            target = lambda: jax_survivors(jax_mesh(4), [1, 3])
        else:
            target = lambda: jax_mesh(new * S, stage=S)
        sink, stats, _ = jrun(old, edges, feats, driver,
                              reshard_mesh=target, S=S, **kw)
        out[name] = {"sink": np.asarray(sink), "stats": stats}
    pipe = jbuild(2, S=2)
    jfeed(pipe, edges[:96], feats, "tick")
    pipe.flush(max_ticks=128)
    pipe.reshard(jax_mesh(4))
    jfeed(pipe, edges[96:], feats, "tick")
    pipe.flush(max_ticks=128)
    out["quiescence"] = {"stats": jstats(pipe),
                         "sink": np.asarray(jax.device_get(pipe.sink))}
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX summaries, the port's per-rank results, the port's local
    golden), the JAX subprocess and the gloo ranks side by side."""
    import jax

    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro_torch.convert import params_from_numpy
    out = tmp_path_factory.mktemp("reshard") / "ref.pkl"
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
            np.asarray, JaxSAGE((8, 8, 8)).init(jax.random.key(0))))
        port = spawn_stream_mesh(N_RANKS, _port_rank, backend="gloo",
                                 device="cpu", args=(params,),
                                 timeout=TIMEOUT)
        local = _local_golden(params)
        log, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return ref, port, local


def _holders(port, name, n):
    got = [p[name] for p in port]
    held = [g for g in got if g is not None]
    assert len(held) == n, f"{name}: {len(held)} ranks hold the pipeline"
    return held


def _same_as_jax(got, want):
    assert got["stats"] == want["stats"]
    np.testing.assert_allclose(got["sink"], want["sink"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("driver", ["tick", "super"])
@pytest.mark.parametrize("d_old,d_new", [(4, 2), (2, 4)],
                         ids=["down", "up"])
def test_reshard_mid_stream_golden(runs, driver, d_old, d_new):
    """Mid-stream reshard (scale-down AND scale-up, both drivers) with
    in-flight windows: the flushed sink is BIT-equal to the local run,
    every logical stat matches exactly, nothing dropped; and = JAX's."""
    ref, port, local = runs
    name = f"{'down' if d_old > d_new else 'up'}-{driver}"
    for r in _holders(port, name, d_new):
        np.testing.assert_array_equal(r["sink"], local["sink"])
        assert r["stats"] == local["stats"]
        assert r["stats"]["dropped"] == 0 == r["stats"]["route_dropped"]
        assert r["n_data"] == d_new
        _same_as_jax(r, ref[name])
    assert local["stats"] == ref["local"][1]
    np.testing.assert_allclose(local["sink"], ref["local"][0], rtol=1e-5,
                               atol=1e-5)


def test_reshard_to_local_and_survivors(runs):
    """Degenerate directions: mesh -> a local pipeline on the old mesh's
    rank 0, and a survivor mesh (data shards 1 and 3 lost)."""
    ref, port, local = runs
    (r,) = _holders(port, "to-local", 1)
    assert port[0]["to-local"] is r and r["local"]
    np.testing.assert_array_equal(r["sink"], local["sink"])
    _same_as_jax(r, ref["to-local"])
    held = _holders(port, "survivors", 2)
    assert [p["survivors"] is not None for p in port] == [True, False,
                                                          True, False]
    for r in held:
        np.testing.assert_array_equal(r["sink"], local["sink"])
        assert r["n_data"] == 2 and r["stats"]["route_dropped"] == 0
        _same_as_jax(r, ref["survivors"])


def test_reshard_capped_defer_rings_survive(runs):
    """A capped wire (route_cap 8): the defer rings hold in-flight rows
    across the reshard, ZERO route drops; within 1e-5 of the uncapped
    local run (deferral shifts rows across tick boundaries)."""
    ref, port, local = runs
    for r in _holders(port, "capped", 2):
        # a rank's ring holds its RMI lane: edge_tick_cap + 2 parts x
        # edge_cap rows
        assert r["ring_rows"] == [32 + 2 * 128] * 2
        np.testing.assert_allclose(r["sink"], local["sink"], rtol=1e-5,
                                   atol=1e-5)
        assert r["stats"]["route_dropped"] == 0 == r["stats"]["dropped"]
        _same_as_jax(r, ref["capped"])


@pytest.mark.parametrize("driver", ["tick", "super"])
def test_reshard_stage_grid_data_axis(runs, driver):
    """A 2-stage grid's data-axis reshard (2 x 2 -> 2 x 1): bit-equal to
    the uninterrupted run at the same stage count, within 1e-5 of the
    local run; the inter-stage ring's rows re-block by part ownership."""
    ref, port, local = runs
    plain = _holders(port, f"stage-uninterrupted-{driver}", 4)[0]
    for r in _holders(port, f"stage-data-{driver}", 2):
        np.testing.assert_array_equal(r["sink"], plain["sink"])
        assert r["stats"] == plain["stats"] and r["n_data"] == 1
        np.testing.assert_allclose(r["sink"], local["sink"], rtol=1e-5,
                                   atol=1e-5)
        _same_as_jax(r, ref[f"stage-data-{driver}"])
    _same_as_jax(plain, ref[f"stage-uninterrupted-{driver}"])


def test_reshard_stage_change_needs_quiescence(runs):
    """Changing the STAGE count with rows in the inter-stage ring raises
    (flush first) on every rank; after the flush it succeeds, within 1e-5
    of the local run and of JAX's."""
    ref, port, local = runs
    for p in port:
        q = p["quiescence"]
        assert "flush" in q["refused"] and "inter-stage ring" in q["refused"]
        np.testing.assert_allclose(q["sink"], local["sink"], rtol=1e-5,
                                   atol=1e-5)
        _same_as_jax(q, ref["quiescence"])


def _refusal_rank(world, params):
    """reshard's refusals on every rank: the planes cannot be switched."""
    mesh = make_stream_mesh(world.device)
    pipe = _build(mesh, params)
    out = {}
    for key, cfg in (("train", dict(train_cap=8)),
                     ("telemetry", dict(telemetry=True)),
                     ("stages", dict(n_stages=2))):
        try:
            pipe.reshard(make_stream_mesh(world.device),
                         cfg=replace(pipe.cfg, **cfg))
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    try:
        pipe.reshard(object())
    except TypeError as e:
        out["type"] = str(e)
    return out


def test_reshard_refusals():
    """The training and telemetry planes cannot be switched on or off by
    a reshard; the new mesh's stage count must match the config's; a new
    mesh must be a StreamMesh."""
    params = GraphSAGE((8, 8, 8)).state_dict()
    for r in spawn_stream_mesh(2, _refusal_rank, backend="gloo",
                               device="cpu", args=(params,),
                               timeout=TIMEOUT):
        assert "training plane" in r["train"]
        assert "telemetry plane" in r["telemetry"]
        assert "must agree" in r["stages"]
        assert "StreamMesh" in r["type"]


if __name__ == "__main__":
    jax_reference(sys.argv[1])
