"""The port's mesh chaos drills against the JAX package's, on the CPU:
fail-stop shard loss with recovery onto the survivors, the fail-slow
shard that `mitigate_stragglers` reshards away (on a 1-D mesh and on a
2-stage grid), and `simulate_failure_and_recover` on a mesh.

Four gloo ranks (`launch/mesh.py:spawn_stream_mesh`, CPU tensors) run
`repro_torch.ft.chaos`'s drills, every rank calling them as the drills'
collective contract asks; a subprocess runs `repro.ft.chaos`'s on a
forced 4-device CPU mesh. Both start together.

The drills draw their weights from the seed in each package (torch and
jax.random differ), so the port is held to test_chaos.py's own goldens
(the recovered sink BIT-equal to the uninterrupted run's, the held
consistent answers bit-equal, nothing dropped, the slow shard owning
nothing) and to JAX's reports on everything the weights do not decide:
the cut and restored step, the drop counters, the session's counters,
the answered qids and their ok flags, the rescale plan, the tick the
mitigation fires at and the parts each shard owns after it. The mesh
recovery (`simulate_failure_and_recover`, 4 -> 2 ranks) runs JAX's
weights: its sink is within 1e-5 of JAX's and 1e-4 of the oracle.

The fail-slow drills feed the straggler mitigator a synthetic wall
schedule, and each tick also feeds it the tick's live wall. A live wall
depends on the box's load, so on both sides the drills run with a fixed
clock standing in for `time` in the pipeline module (`fixed_clock`):
every live wall reads 0 s and the outcome is the schedule's alone. A
third port drill puts one load-like wall spike into one rank's live feed
(`spiked_feed`): the mesh still takes one decision, so its report equals
JAX's unspiked one.
"""
import os
import pickle
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.ft import chaos as tchaos
from repro_torch.graph.sage import GraphSAGE
from repro_torch.launch.mesh import make_stream_mesh, spawn_stream_mesh

REPO = Path(__file__).resolve().parents[1]
N_RANKS, TIMEOUT = 4, 600
N_NODES, D, DIMS = 40, 6, (6, 12, 12)
CAPS = dict(n_parts=4, node_cap=64, edge_cap=256, repl_cap=256,
            feat_cap=256, edge_tick_cap=64, max_nodes=N_NODES)


def make_stream(seed=2, n_edges=120):
    """test_fault_tolerance.make_stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


class FixedClock:
    """Stands in for a pipeline module's `time` module: `perf_counter`
    reads one constant, so every live wall the straggler feed sees is 0 s
    (both pipeline modules read no other clock)."""

    @staticmethod
    def perf_counter() -> float:
        return 0.0


@contextmanager
def fixed_clock(module):
    """Run with `FixedClock` as `module.time` (a pipeline module)."""
    saved = module.time
    module.time = FixedClock
    try:
        yield
    finally:
        module.time = saved


SPIKE_RANK, SPIKE_S = 2, 60.0


@contextmanager
def spiked_feed(rank: int):
    """On world rank SPIKE_RANK, add a SPIKE_S s wall to the live feed of
    the first tick, as a loaded box stalls one rank: that rank's EWMA
    then stays far above the drill's slow walls, so its own flags never
    persist while the other ranks' do."""
    import repro_torch.core.pipeline as tpipe
    saved = tpipe.D3Pipeline._trace_ticks

    def trace_ticks(self, occ_rows, tick0, wall_s, *rest, **kw):
        if tick0 == 0:
            wall_s += SPIKE_S
        return saved(self, occ_rows, tick0, wall_s, *rest, **kw)

    if rank == SPIKE_RANK:
        tpipe.D3Pipeline._trace_ticks = trace_ticks
    try:
        yield
    finally:
        tpipe.D3Pipeline._trace_ticks = saved


def _answers(ans: dict) -> dict:
    """{qid: (ok, vec)} of a drill's answer dict."""
    return {int(q): (bool(a.ok), np.asarray(a.vec)) for q, a in ans.items()}


def _failstop_summary(rep):
    if rep is None:
        return None
    out = {k: rep[k] for k in ("restored_step", "dropped", "route_dropped",
                               "oracle_dropped", "n_chunks", "cut",
                               "fail_at")}
    out["stats"] = {k: v for k, v in rep["stats"].items()
                    if not k.endswith("_ms")}
    out["oracle_sink"] = np.asarray(rep["oracle_sink"])
    out["chaos_sink"] = np.asarray(rep["chaos_sink"])
    out["oracle_answers"] = _answers(rep["oracle_answers"])
    out["chaos_answers"] = _answers(rep["chaos_answers"])
    return out


def _slow_summary(rep):
    if rep is None:
        return None
    plan = rep["plan"]
    return {"plan": None if plan is None else (
        plan.old_parallelism, plan.new_parallelism, plan.moves),
        "mitigated_at_chunk": rep["mitigated_at_chunk"],
        "parts_before": [p.tolist() for p in rep["parts_before"]],
        "parts_after": [p.tolist() for p in rep["parts_after"]],
        "n_data_after": rep["n_data_after"], "dropped": rep["dropped"],
        "route_dropped": rep["route_dropped"],
        "ticks_observed": rep["ticks_observed"]}


# ------------------------------------------------------------ port side

def _recover_rank(world, params, ckpt_dir):
    """test_failure_recovery_rescale on a 4-rank mesh: checkpoint, lose
    half the ranks, restore and reshard onto the first two, finish."""
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.elastic import simulate_failure_and_recover

    def make():
        model = GraphSAGE(DIMS)
        model.load_state_dict(params)
        return D3Pipeline(model, PipelineConfig(
            **CAPS, base_parallelism=4,
            window=win.WindowConfig(kind=win.SESSION, interval=4)),
            mesh=make_stream_mesh(world.device))

    edges, feats = make_stream()
    pipe = make()
    pipe.run_stream(edges[:60], feats, tick_edges=16)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save_pipeline(step=5, pipe=pipe)
    pipe2 = make()
    cfg_before = pipe2.cfg
    step, plan, new_cfg = simulate_failure_and_recover(pipe2, mgr, 5,
                                                       new_parallelism=2)
    out = {"step": step, "moves": plan.moves, "base": new_cfg.base_parallelism,
           "fresh_cfg": new_cfg is pipe2.cfg and new_cfg is not cfg_before,
           "old_base": cfg_before.base_parallelism,
           "active": pipe2.active}
    if pipe2.active:
        pipe2.run_stream(edges[60:], feats, tick_edges=16)
        pipe2.flush(max_ticks=128)
        out["n_data"] = pipe2._n_data
        out["emb"] = pipe2.embeddings()
    return out


def _port_rank(world, params, tmp):
    out = {}
    for driver in ("tick", "super"):
        out["failstop", driver] = _failstop_summary(tchaos.scenario_failstop(
            tchaos.ChaosConfig(driver=driver), Path(tmp) / f"fs-{driver}",
            device=world.device))
    import repro_torch.core.pipeline as tpipe
    with fixed_clock(tpipe):
        out["slow"] = _slow_summary(tchaos.scenario_slow_shard(
            tchaos.ChaosConfig(), device=world.device))
        out["slow-stage"] = _slow_summary(tchaos.scenario_slow_shard(
            tchaos.ChaosConfig(), d_old=2, n_stages=2, device=world.device))
        with spiked_feed(world.rank):
            out["slow-spiked"] = _slow_summary(tchaos.scenario_slow_shard(
                tchaos.ChaosConfig(), device=world.device))
    out["recover"] = _recover_rank(world, params, str(Path(tmp) / "rec"))
    return out


# ------------------------------------------------------------- JAX side

def jax_reference(path, tmp):
    """The same drills through `repro.ft.chaos` on a forced 4-device mesh,
    and the mesh recovery through `repro.ft.elastic`."""
    import jax
    from repro.core import windowing as jwin
    from repro.core.pipeline import D3Pipeline as JaxPipeline
    from repro.core.pipeline import PipelineConfig as JaxConfig
    from repro.ft import chaos as jchaos
    from repro.ft.checkpoint import CheckpointManager as JaxManager
    from repro.ft.elastic import simulate_failure_and_recover as jsim
    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro.launch.mesh import make_stream_mesh as jax_mesh

    out = {}
    for driver in ("tick", "super"):
        out["failstop", driver] = _failstop_summary(jchaos.scenario_failstop(
            jchaos.ChaosConfig(driver=driver), Path(tmp) / f"jfs-{driver}"))
    import repro.core.pipeline as jpipe
    with fixed_clock(jpipe):
        out["slow"] = _slow_summary(jchaos.scenario_slow_shard(
            jchaos.ChaosConfig()))
        out["slow-stage"] = _slow_summary(jchaos.scenario_slow_shard(
            jchaos.ChaosConfig(), d_old=2, n_stages=2))

    def make():
        model = JaxSAGE(DIMS)
        return JaxPipeline(model, model.init(jax.random.key(0)), JaxConfig(
            **CAPS, base_parallelism=4,
            window=jwin.WindowConfig(kind=jwin.SESSION, interval=4)),
            mesh=jax_mesh(4))

    edges, feats = make_stream()
    pipe = make()
    pipe.run_stream(edges[:60], feats, tick_edges=16)
    mgr = JaxManager(Path(tmp) / "jrec")
    mgr.save_pipeline(step=5, pipe=pipe)
    pipe2 = make()
    step, plan, new_cfg = jsim(pipe2, mgr, 5, new_parallelism=2)
    pipe2.run_stream(edges[60:], feats, tick_edges=16)
    pipe2.flush(max_ticks=128)
    out["recover"] = {"step": step, "moves": plan.moves,
                      "base": new_cfg.base_parallelism,
                      "n_data": pipe2._n_data, "emb": pipe2.embeddings()}
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.graph.sage import GraphSAGE as JaxSAGE
    from repro_torch.convert import params_from_numpy
    tmp = tmp_path_factory.mktemp("chaos_mesh")
    out = tmp / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS} "
                         "--xla_backend_optimization_level=0 "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(out), str(tmp)], env=env,
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        params = params_from_numpy(jax.tree.map(
            np.asarray, JaxSAGE(DIMS).init(jax.random.key(0))))
        port = spawn_stream_mesh(N_RANKS, _port_rank, backend="gloo",
                                 device="cpu", args=(params, str(tmp)),
                                 timeout=TIMEOUT)
        log, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return ref, port, params


@pytest.mark.parametrize("driver", ["tick", "super"])
def test_chaos_failstop_recovery_bit_equal(runs, driver):
    """Hub-heavy spike + fail-stop loss of 2/4 shards mid-stream ->
    checkpoint-restore + reshard onto the survivors + replay: nothing
    dropped, the held consistent answers and the recovered sink
    bit-equal to the uninterrupted run's; JAX's counters and answers."""
    ref, port, _ = runs
    want = ref["failstop", driver]
    reps = [p["failstop", driver] for p in port]
    assert [r is not None for r in reps] == [True, False, True, False]
    for rep in (r for r in reps if r is not None):
        assert rep["dropped"] == 0 and rep["route_dropped"] == 0
        np.testing.assert_array_equal(rep["oracle_sink"], rep["chaos_sink"])
        assert rep["oracle_answers"] and (set(rep["oracle_answers"])
                                          == set(rep["chaos_answers"]))
        for qid, (ok, vec) in rep["oracle_answers"].items():
            c_ok, c_vec = rep["chaos_answers"][qid]
            assert ok and c_ok
            np.testing.assert_array_equal(vec, c_vec)
        assert rep["restored_step"] == rep["cut"]
        assert rep["stats"]["degraded"] is None
        assert rep["stats"]["degraded_ticks"] > 0
        for k in ("restored_step", "dropped", "route_dropped",
                  "oracle_dropped", "n_chunks", "cut", "fail_at", "stats"):
            assert rep[k] == want[k], k
        for key in ("oracle_answers", "chaos_answers"):
            assert {q: ok for q, (ok, _) in rep[key].items()} == \
                {q: ok for q, (ok, _) in want[key].items()}
        assert rep["chaos_sink"].shape == want["chaos_sink"].shape


def test_chaos_slow_shard_mitigated(runs):
    """Fail-slow shard: flagged by the deterministic wall schedule, then
    resharded away (4 -> 2, a divisor of the 4 parts): the surviving
    shards own every part, nothing dropped; the same plan, tick and
    re-map as JAX's."""
    ref, port, _ = runs
    reps = [p["slow"] for p in port]
    assert [r is not None for r in reps] == [True, False, True, False]
    for rep in (r for r in reps if r is not None):
        assert rep["plan"] is not None
        assert rep["mitigated_at_chunk"] is not None
        assert rep["n_data_after"] == 2
        assert sum(len(p) for p in rep["parts_after"]) == 4
        assert rep["dropped"] == 0 and rep["route_dropped"] == 0
        assert rep == ref["slow"]


def test_one_rank_wall_spike_leaves_the_slow_drill_unchanged(runs):
    """One rank's live feed spikes on the first tick (`spiked_feed`), so
    that rank alone never holds a persistent flag: the mesh still
    reshards once, all four ranks together, and the report is JAX's
    unspiked one."""
    ref, port, _ = runs
    reps = [p["slow-spiked"] for p in port]
    assert [r is not None for r in reps] == [True, False, True, False]
    for rep in (r for r in reps if r is not None):
        assert rep == ref["slow"]


def test_straggler_remap_on_stage_grid(runs):
    """Fail-slow shard under a 2-stage grid: `mitigate_stragglers()`
    reshards onto the surviving data column (2 x 2 -> 2 x 1) and
    `parts_per_shard()` re-maps end to end, as in JAX."""
    ref, port, _ = runs
    reps = [p["slow-stage"] for p in port]
    assert [r is not None for r in reps] == [True, False, True, False]
    for rep in (r for r in reps if r is not None):
        assert rep["plan"] is not None and rep["n_data_after"] == 1
        assert rep["parts_after"] == [[0, 1, 2, 3]]
        assert rep["dropped"] == 0 and rep["route_dropped"] == 0
        assert rep == ref["slow-stage"]


def test_mesh_failure_recovery_rescale(runs):
    """simulate_failure_and_recover on a 4-rank mesh: the checkpoint
    restores, the carry reshards onto the first two ranks (the others
    keep nothing), the config is a fresh one at parallelism 2; the
    finished sink within 1e-5 of JAX's and 1e-4 of the oracle."""
    from repro_torch.core.oracle import build_snapshot, oracle_embeddings
    ref, port, params = runs
    want = ref["recover"]
    recs = [p["recover"] for p in port]
    assert [r["active"] for r in recs] == [True, True, False, False]
    edges, feats = make_stream()
    model = GraphSAGE(DIMS)
    model.load_state_dict(params)
    g, _ = build_snapshot(edges, feats, D, N_NODES, "cpu")
    oracle = oracle_embeddings(model, g).numpy()
    for r in recs:
        assert r["step"] == want["step"] == 5
        assert r["moves"] == want["moves"] and r["base"] == want["base"] == 2
        assert r["fresh_cfg"] and r["old_base"] == 4
        if not r["active"]:
            continue
        assert r["n_data"] == want["n_data"] == 2
        assert set(r["emb"]) == set(want["emb"]) and r["emb"]
        for vid, vec in want["emb"].items():
            np.testing.assert_allclose(r["emb"][vid], vec, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(r["emb"][vid], oracle[vid],
                                       rtol=1e-4, atol=1e-4)


if __name__ == "__main__":
    jax_reference(*sys.argv[1:])
