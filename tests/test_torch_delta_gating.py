"""Delta-gated propagation in the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through JAX and the port:

  * the aggregator gates (core/aggregators.GATES): equal decisions, the
    MAX/MIN gates one-sided;
  * `coalesce_msg_batch`: record for record equal part / slot / src_part
    / valid and counts, vec within 1e-5 (rtol and atol), on both delivery
    backends;
  * delta_eps = 0: bit-identical to the default (ungated) program —
    embeddings, integer stats, suppressed == 0 — for all four window
    policies and both drivers;
  * tests/test_delta_gating.py's update-wave stream at eps = 1e-3, both
    drivers, both backends: every integer stat (suppressed included) of
    every tick equals JAX's. A gate decision may only differ where the
    message moved by eps to within f32 rounding: on a mismatch the test
    prints the smallest margin |d2 - eps^2| / eps^2 over that tick's
    gated candidates and accepts the tick only when it is below 1e-5.
    The embeddings stay within the Lipschitz chain bound of the static
    oracle (test_delta_gating.py:sage_error_bound), and flush terminates
    over suppressed residuals.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import windowing as jwin
from repro.core.events import MsgBatch as JMsgBatch
from repro.core.events import coalesce_msg_batch as jcoalesce
from repro.core.pipeline import D3Pipeline as JaxPipeline
from repro.core.pipeline import PipelineConfig as JaxConfig
from repro.graph.sage import GraphSAGE as JaxSAGE
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregators as tagg
from repro_torch.core import windowing as twin
from repro_torch.core.delivery import make_delivery
from repro_torch.core.events import MsgBatch, coalesce_msg_batch
from repro_torch.core.oracle import build_snapshot, oracle_embeddings
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.graph.sage import GraphSAGE

N_NODES, D_IN, DIMS = 32, 8, (8, 12, 12)
CAPS = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES)
POLICIES = ["streaming", "tumbling", "session", "adaptive"]
EPS = 1e-3
MARGIN = 1e-5
INT_STATS = ("ticks", "reduce_msgs", "broadcast_msgs", "cross_part_msgs",
             "emitted_total", "dropped", "suppressed")
STAT_FIELDS = ("broadcast_msgs", "reduce_msgs", "cross_part_msgs",
               "emitted", "dropped", "n_suppressed")


def make_stream(seed=0, n_edges=100):
    """test_delta_gating.make_stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def tiny_update_waves(rng, feats, n_waves=6, scale=2e-4):
    """test_delta_gating._tiny_update_waves: waves of sub-eps feature
    perturbations of every vertex. Returns (waves, final features)."""
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
    return waves, cur


@pytest.fixture(scope="module")
def jparams():
    return JaxSAGE(DIMS).init(jax.random.key(0))


def port_model(jparams):
    model = GraphSAGE(DIMS)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray,
                                                         jparams)))
    return model


def port_pipe(jparams, backend="kernel", kind="streaming", **kw):
    return D3Pipeline(port_model(jparams), PipelineConfig(
        **CAPS, window=twin.WindowConfig(kind=kind, interval=3),
        delivery_backend=backend, **kw), device="cpu")


# ------------------------------------------------------------- the gates

@pytest.mark.parametrize("kind", ["mean", "sum", "max", "min"])
def test_gates_match_jax(kind):
    rng = np.random.default_rng(1)
    old = rng.normal(size=(64, 6)).astype(np.float32)
    step = rng.normal(size=(64, 6)).astype(np.float32)
    step *= (rng.random((64, 1)) * 2e-3).astype(np.float32)
    new = old + step
    want = np.asarray(jagg.GATES[kind](jnp.asarray(new), jnp.asarray(old),
                                       EPS))
    got = tagg.GATES[kind](torch.from_numpy(new), torch.from_numpy(old),
                           EPS).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want), "inputs must straddle the gate"


def test_max_min_gates_are_one_sided():
    old = torch.tensor([[1.0, 1.0], [1.0, 1.0], [1.0, 1.0]])
    new = torch.tensor([[0.0, -9.0], [1.0 + 5e-4, 1.0], [1.0, 1.0 + 2e-3]])
    assert tagg.GATES["max"](new, old, EPS).tolist() == [True, True, False]
    assert tagg.GATES["min"](-new, -old, EPS).tolist() == [True, True, False]
    assert not bool(tagg.GATES["mean"](new, old, EPS)[0])
    assert GraphSAGE(DIMS).layers[0].agg_kind == "mean"
    assert tagg.READERS["sum"](old, None) is old


# ------------------------------------------------------------ coalescing

def _batches(seed, C=64, n_parts=4, n_slots=8, d=5, live=0.7):
    rng = np.random.default_rng(seed)
    cols = dict(part=rng.integers(0, n_parts, C),
                slot=rng.integers(0, n_slots, C),
                vec=rng.normal(size=(C, d)).astype(np.float32),
                cnt=rng.integers(0, 2, C).astype(np.float32),
                src_part=rng.integers(0, n_parts, C),
                valid=rng.random(C) < live)
    jb = JMsgBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype ==
                                     np.int64 else v)
                      for k, v in cols.items()})
    tb = MsgBatch(**{k: torch.from_numpy(v) for k, v in cols.items()})
    return jb, tb


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("seed,live", [(3, 0.7), (4, 1.0), (5, 0.0),
                                       (6, 0.3)])
def test_coalesce_matches_jax(backend, seed, live):
    jb, tb = _batches(seed, live=live)
    want = jcoalesce(jb, 8)
    got = coalesce_msg_batch(tb, 8, make_delivery(backend))
    for k in ("part", "slot", "src_part", "valid", "cnt"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    np.testing.assert_allclose(got.vec.numpy(), np.asarray(want.vec),
                               rtol=1e-5, atol=1e-5)


def test_coalesce_all_distinct_keeps_every_record():
    b = MsgBatch(part=torch.tensor([0, 1, 2, 3]),
                 slot=torch.tensor([1, 1, 1, 1]),
                 vec=torch.arange(8.0).reshape(4, 2),
                 cnt=torch.tensor([1.0, 0.0, 1.0, 0.0]),
                 src_part=torch.tensor([3, 2, 1, 0]),
                 valid=torch.ones(4, dtype=torch.bool))
    out = coalesce_msg_batch(b, 4, make_delivery("kernel"))
    assert out.valid.all()
    for k in ("part", "slot", "vec", "cnt", "src_part"):
        assert torch.equal(getattr(out, k), getattr(b, k)), k


# ------------------------------------- eps = 0: the ungated program

def _drive(pipe, driver, edges, feats):
    if driver == "super":
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        pipe.flush_super(max_ticks=96, T=4)
    else:
        pipe.run_stream(edges, feats, tick_edges=24)
        pipe.flush(max_ticks=96)
    return pipe


def assert_bit_identical(ref, other):
    for k in INT_STATS:
        assert getattr(other.metrics, k) == getattr(ref.metrics, k), k
    assert other.metrics.suppressed == 0
    np.testing.assert_array_equal(other.metrics.busy_logical,
                                  ref.metrics.busy_logical)
    a, b = ref.embeddings(), other.embeddings()
    assert set(a) == set(b) and a
    for vid in a:
        np.testing.assert_array_equal(b[vid], a[vid])


@pytest.mark.parametrize("kind", POLICIES)
def test_eps0_golden_matrix(jparams, kind):
    """Explicit delta_eps=0.0 is the default program bit for bit, both
    drivers: no gate, no coalescer."""
    edges, feats = make_stream()
    ref = _drive(port_pipe(jparams, kind=kind), "tick", edges, feats)
    for driver in ("tick", "super"):
        got = _drive(port_pipe(jparams, kind=kind, delta_eps=0.0), driver,
                     edges, feats)
        if driver == "tick":
            assert_bit_identical(ref, got)
        else:
            sup = _drive(port_pipe(jparams, kind=kind), "super", edges,
                         feats)
            assert_bit_identical(sup, got)


# ---------------------------------------- eps > 0: the update waves

def _stats_row(stats):
    return [[int(getattr(s, f)) for f in STAT_FIELDS] for s in stats]


def _run_waves(pipe, driver, edges, feats, waves, record):
    """Build the graph, stream the waves, drain; `record` gets every
    call's per-layer integer stats."""
    if driver == "tick":
        for ch, fe in zip(*pipe.chunk_stream(edges, feats, 24)):
            record.append(_stats_row(pipe.tick(ch, fe)))
        pipe.flush(max_ticks=96)
        for events in waves:
            record.append(_stats_row(pipe.tick(feats=events)))
        pipe.flush(max_ticks=96)
    else:
        e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
        record.append(_stats_row(pipe.run_super_tick(
            e_chunks, f_chunks, T=len(e_chunks))[0]))
        pipe.flush_super(max_ticks=96, T=4)
        for events in waves:
            record.append(_stats_row(pipe.run_super_tick(
                feat_chunks=[events], T=1)[0]))
        pipe.flush_super(max_ticks=96, T=4)
    return pipe


def _gate_margins(pipe):
    """Per layer, the smallest |d2 - eps^2| / eps^2 over the vertices the
    gate would judge now (sent before, still pending a send)."""
    out = []
    for ls in pipe.states:
        d2 = ((ls.feat - ls.x_sent) ** 2).sum(-1)
        judged = ls.has_sent & (ls.feat != ls.x_sent).any(-1)
        m = ((d2 - EPS * EPS).abs() / (EPS * EPS))[judged]
        out.append(float(m.min()) if m.numel() else float("inf"))
    return out


def sage_error_bound(params, eps):
    """test_delta_gating.sage_error_bound, spectral norms in float64."""
    s1n = np.linalg.norm(np.asarray(params["l0"]["neigh"]["w"], np.float64),
                         2)
    s2s = np.linalg.norm(np.asarray(params["l1"]["self"]["w"], np.float64),
                         2)
    s2n = np.linalg.norm(np.asarray(params["l1"]["neigh"]["w"], np.float64),
                         2)
    e1 = s1n * eps
    return float(s2s * e1 + s2n * (e1 + eps))


@pytest.fixture(scope="module")
def jax_waves(jparams):
    """JAX's gated update-wave runs, per driver: (recorded stats,
    metrics, embeddings)."""
    edges, feats = make_stream()
    waves, final = tiny_update_waves(np.random.default_rng(7), feats)
    out = {}
    for driver in ("tick", "super"):
        pipe = JaxPipeline(JaxSAGE(DIMS), jparams, JaxConfig(
            **CAPS, window=jwin.WindowConfig(kind=jwin.STREAMING),
            delta_eps=EPS))
        record = []
        _run_waves(pipe, driver, edges, feats, waves, record)
        out[driver] = (record, {k: getattr(pipe.metrics, k)
                                for k in INT_STATS}, pipe.embeddings())
    return edges, feats, waves, final, out


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_update_waves_match_jax(jparams, jax_waves, driver, backend):
    edges, feats, waves, final, ref = jax_waves
    want_rec, want_m, want_emb = ref[driver]
    pipe = port_pipe(jparams, backend, delta_eps=EPS)
    record = []
    _run_waves(pipe, driver, edges, feats, waves, record)
    got_m = {k: getattr(pipe.metrics, k) for k in INT_STATS}
    if record != want_rec or got_m != want_m:
        margins = _gate_margins(pipe)
        print(f"gate decisions differ from JAX: {got_m} vs {want_m}; "
              f"smallest gate margin |d2 - eps^2| / eps^2 per layer "
              f"{margins} (accepted only below {MARGIN})")
        assert min(margins) < MARGIN
    assert pipe.metrics.suppressed > 0
    # the gated sink against the oracle on the final snapshot: within the
    # Lipschitz chain bound (with test_delta_gating.py's f32 slack)
    model = port_model(jparams)
    g, _ = build_snapshot(edges, final, D_IN, N_NODES, "cpu",
                          dtype=torch.float64)
    oracle = oracle_embeddings(model.double(), g).numpy()
    bound = sage_error_bound(jparams, EPS)
    emb = pipe.embeddings()
    assert set(emb) == set(want_emb) and emb
    worst = max(float(np.linalg.norm(emb[v] - oracle[v])) for v in emb)
    assert worst <= bound * 1.01 + 1e-5, (worst, bound)
    assert 1e-5 < bound < float(np.linalg.norm(oracle))
    for vid, vec in want_emb.items():
        np.testing.assert_allclose(emb[vid], vec, rtol=1e-5, atol=1e-5)


def test_gating_saves_messages_and_flush_terminates(jparams):
    """Against the exact run on the same waves: gated + suppressed never
    exceeds the exact volume, and a stream ending on sub-eps updates
    still quiesces within a tight flush budget on both drivers."""
    edges, feats = make_stream()
    waves, _ = tiny_update_waves(np.random.default_rng(7), feats)
    exact = _run_waves(port_pipe(jparams), "tick", edges, feats, waves, [])
    gated = _run_waves(port_pipe(jparams, delta_eps=EPS), "tick", edges,
                       feats, waves, [])
    assert exact.metrics.suppressed == 0 < gated.metrics.suppressed
    assert gated.metrics.reduce_msgs < exact.metrics.reduce_msgs
    assert (gated.metrics.reduce_msgs + gated.metrics.suppressed
            <= exact.metrics.reduce_msgs)
    small, _ = tiny_update_waves(np.random.default_rng(11), feats,
                                 n_waves=2, scale=1e-4)
    per = _drive(port_pipe(jparams, delta_eps=EPS), "tick", edges, feats)
    for events in small:
        per.tick(feats=events)
    assert per.flush(max_ticks=16) <= 16 and per.metrics.suppressed > 0
    sup = _drive(port_pipe(jparams, delta_eps=EPS), "super", edges, feats)
    for events in small:
        sup.run_super_tick(feat_chunks=[events], T=1)
    assert sup.flush_super(max_ticks=16, T=4) <= 16
    assert sup.metrics.suppressed > 0
