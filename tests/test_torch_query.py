"""The port's query plane (serve/query.py, the pipeline's hooks and
serve/session.py:ServeSession) against the JAX package's.

  * `admit` and both device stages on the same numpy inputs: slots, drop
    masks, wire records, answers and counters;
  * the golden serving matrix of tests/test_query_plane.py: the port's
    {per-tick, super-tick} x {"kernel" (plain versions on the CPU),
    "scatter"} against JAX's reference configuration (LocalRouter,
    per-tick, xla);
  * behaviour: stale_ok reads equal read_nodes of the same tick,
    consistent reads equal the static oracle after a flush, host
    rejections, pending-table overflow, metrics, query_cap=0, the
    super-tick's single stats read;
  * ServeSession scripts (both drivers, shed, retry with backoff, degrade /
    restore, the retention bound) against JAX's ServeSession.

Tolerances (tests/test_query_plane.py's own): qid, kind, ok, tick, issue,
slots, masks and every integer counter exactly equal; vec within
rtol = atol = 1e-5; score within rtol 1e-4, atol 1e-5. Latencies are host
wall time and are not compared.
"""
import sys
from dataclasses import fields
from pathlib import Path
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import state as jst
from repro.core.tick import zero_stats as jax_zero_stats
from repro.serve import query as jq
from repro.serve.session import ServeSession as JaxSession
from repro_torch.convert import params_from_numpy
from repro_torch.core import state as tst
from repro_torch.core import windowing as twin
from repro_torch.core.oracle import build_snapshot, oracle_embeddings
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.core.tick import zero_stats
from repro_torch.graph.sage import GraphSAGE
from repro_torch.serve import query as tq
from repro_torch.serve.session import ServeSession

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_query_plane import (D_IN, N_NODES, assert_answers_match,  # noqa
                              build_pipe, canon, chunked, make_stream,
                              query_mix, run_config)

DIMS = (D_IN, 12, 12)
VEC_TOL = dict(rtol=1e-5, atol=1e-5)


class Stub:
    """A router for one block of parts starting at part0 (both packages'
    stages read part0, psum and psum_vote; one rank: identities)."""
    n_stages = 1

    def __init__(self, part0):
        self._p0 = part0

    def part0(self):
        return self._p0

    def psum(self, x):
        return x

    psum_vote = psum


# ------------------------------------------------------- numpy inputs

def np_state(rng, P, Q, d, pending=0.5, K=0, occupied=0):
    s = {"qid": rng.integers(0, 2 ** 20, (P, Q)),
         "kind": rng.integers(0, 3, (P, Q)),
         "slot": rng.integers(0, 16, (P, Q)),
         "part2": rng.integers(0, 8, (P, Q)),
         "slot2": rng.integers(0, 16, (P, Q)),
         "consistent": rng.random((P, Q)) < 0.5,
         "ok": rng.random((P, Q)) < 0.8,
         "issue": rng.integers(0, 50, (P, Q)),
         "vec": rng.normal(size=(P, Q, d)).astype(np.float32),
         "pending": rng.random((P, Q)) < pending,
         "wire_defer": rng.normal(size=(K, d + 10)).astype(np.float32),
         "wire_defer_ok": np.arange(K) < occupied}
    return s


def np_batch(rng, C, n, d, parts, kinds=(0, 1, 2)):
    valid = np.zeros(C, bool)
    valid[rng.permutation(C)[:n]] = True
    return {"qid": rng.integers(0, 2 ** 20, C),
            "kind": rng.choice(kinds, C),
            "part": rng.integers(*parts, C),
            "slot": rng.integers(0, 16, C),
            "part2": rng.integers(0, 8, C),
            "slot2": rng.integers(0, 16, C),
            "consistent": rng.random(C) < 0.5,
            "ok": rng.random(C) < 0.8,
            "issue": rng.integers(0, 50, C),
            "vec": rng.normal(size=(C, d)).astype(np.float32),
            "valid": valid}


def to_jax(cls, cols):
    return cls(**{f.name: jnp.asarray(
        cols[f.name].astype(np.int32) if cols[f.name].dtype == np.int64
        else cols[f.name]) for f in fields(cls)})


def to_torch(cls, cols):
    return cls(**{f.name: torch.as_tensor(cols[f.name])
                  for f in fields(cls)})


def assert_same(got, want, what, tol=None):
    """Port dataclass vs JAX dataclass: ints / bools exact, floats within
    `tol` (VEC_TOL when None)."""
    for f in fields(got):
        g = getattr(got, f.name).numpy()
        w = np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, (what, f.name, g.shape, w.shape)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, **(tol or VEC_TOL),
                                       err_msg=f"{what}.{f.name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f.name}")


# -------------------------------------------------------------- admit

ADMIT_CASES = [  # P, Q, C, n, part0, parts range, pending share
    (2, 2, 4, 3, 0, (0, 1), 0.0),      # the JAX unit case: third drops
    (4, 8, 32, 20, 0, (0, 4), 0.5),
    (4, 8, 64, 64, 0, (0, 4), 0.9),    # nearly full: most drop
    (2, 4, 32, 25, 2, (0, 8), 0.3),    # off-block rows (part0 = 2)
    (1, 3, 16, 16, 5, (4, 7), 0.0),    # one local part, many off-block
    (8, 1, 40, 40, 0, (0, 8), 0.5),
    (4, 8, 16, 0, 0, (0, 4), 0.5)]     # nothing valid


@pytest.mark.parametrize("case", ADMIT_CASES)
def test_admit_equals_jax(case):
    P, Q, C, n, part0, parts, pend = case
    rng = np.random.default_rng(P * 31 + Q + C)
    s, b = np_state(rng, P, Q, 4, pend), np_batch(rng, C, n, 4, parts)
    j_new, j_n, j_drop = jq.admit(to_jax(jq.QueryState, s),
                                  to_jax(jq.QueryBatch, b), jnp.int32(part0))
    t_new, t_n, t_drop = tq.admit(to_torch(tq.QueryState, s),
                                  to_torch(tq.QueryBatch, b), part0)
    assert_same(t_new, j_new, "state", tol=dict(rtol=0, atol=0))
    assert int(t_n) == int(j_n)
    np.testing.assert_array_equal(t_drop.numpy(), np.asarray(j_drop))
    if case[0] == 2 and case[1] == 2:
        assert int(t_n) == 2 and int(t_drop.sum()) == 1


# ------------------------------------------------------- both stages

def layer_states(rng, P, N, d, n_layers=2, dirty=0.1, ring=False):
    """The same LayerStates in both packages: random pending flags, and
    optionally an occupied defer ring (pending work)."""
    js, ts = [], []
    for _ in range(n_layers):
        red = rng.random((P, N)) < dirty
        fwd = rng.random((P, N)) < dirty
        k = 4 if ring else 0
        ok = np.arange(k) < (1 if ring else 0)
        j = jst.init_layer(P, N, d, d, rmi_defer_rows=k)
        j = j.__class__(**{**{f.name: getattr(j, f.name) for f in fields(j)},
                           "red_pending": jnp.asarray(red),
                           "fwd_pending": jnp.asarray(fwd),
                           "rmi_defer_ok": jnp.asarray(ok)})
        t = tst.init_layer(P, N, d, d, "cpu", rmi_defer_rows=k)
        t = t.__class__(**{**{f.name: getattr(t, f.name) for f in fields(t)},
                           "red_pending": torch.as_tensor(red),
                           "fwd_pending": torch.as_tensor(fwd),
                           "rmi_defer_ok": torch.as_tensor(ok)})
        js.append(j)
        ts.append(t)
    return js, ts


STAGE_CASES = [  # dirty share, ring work, batch_work, moved, K, occupied
    (0.0, False, False, 0, 0, 0),      # silent start and end
    (0.0, False, True, 0, 0, 0),       # an update batch: heads wait
    (0.2, False, False, 0, 0, 0),      # dirty rows hold consistent reads
    (0.0, True, False, 0, 0, 0),       # deferred rows: nothing consistent
    (0.0, False, False, 3, 0, 0),      # moved messages: end not silent
    (0.0, False, False, 0, 6, 2),      # wire ring: headroom gate
    (0.1, False, False, 0, 5, 5)]      # full wire ring: no head fires


@pytest.mark.parametrize("case", STAGE_CASES)
def test_stages_equal_jax(case):
    dirty, ring, batch_work, moved, K, occ = case
    P, Q, N, d, C = 4, 8, 16, 6, 12
    rng = np.random.default_rng(int(dirty * 100) + 7 * K + moved + occ)
    s = np_state(rng, P, Q, d, 0.6, K=K, occupied=occ)
    s["slot"] = rng.integers(0, N, (P, Q))
    s["part2"] = rng.integers(0, P, (P, Q))
    b = np_batch(rng, C, 9, d, (0, P), kinds=(0, 1))
    b["vec"][:] = 0.0
    sink = rng.normal(size=(P, N, d)).astype(np.float32)
    seen = rng.random((P, N)) < 0.8
    jls, tls = layer_states(rng, P, N, d, dirty=dirty, ring=ring)
    jr, tr = Stub(jnp.int32(0)), Stub(0)

    j = jq.query_admit_stage(to_jax(jq.QueryState, s),
                             to_jax(jq.QueryBatch, b), tuple(jls),
                             jnp.asarray(sink), jnp.asarray(seen), jr,
                             jnp.asarray(batch_work))
    t = tq.query_admit_stage(to_torch(tq.QueryState, s),
                             to_torch(tq.QueryBatch, b), tls,
                             torch.as_tensor(sink), torch.as_tensor(seen),
                             tr, torch.as_tensor(batch_work))
    assert_same(t[0], j[0], "admitted state")
    assert_same(t[1], j[1], "wire")
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert int(t[3]) == int(j[3])

    # the answer stage on the delivered wire (the LocalRouter's identity)
    # after a fresh sink update
    sink2 = rng.normal(size=(P, N, d)).astype(np.float32)
    jstats = [jax_zero_stats(P) for _ in range(2)]
    jstats[1] = jstats[1].__class__(**{
        **{f.name: getattr(jstats[1], f.name) for f in fields(jstats[1])},
        "reduce_msgs": jnp.int32(moved)})
    tstats = [zero_stats(P, "cpu") for _ in range(2)]
    tstats[1] = tstats[1].__class__(**{
        **{f.name: getattr(tstats[1], f.name) for f in fields(tstats[1])},
        "reduce_msgs": torch.tensor(moved)})
    ja = jq.query_answer_stage(j[0], j[1], to_jax(jq.QueryBatch, b), j[2],
                               j[3], tuple(jls), jnp.asarray(sink2),
                               jnp.asarray(seen), jnp.int32(9), jstats, jr)
    ta = tq.query_answer_stage(t[0], t[1], to_torch(tq.QueryBatch, b), t[2],
                               t[3], tls, torch.as_tensor(sink2),
                               torch.as_tensor(seen), torch.tensor(9),
                               tstats, tr)
    assert_same(ta[0], ja[0], "answered state")
    assert_same(ta[1], ja[1], "answers")
    for f in tq.QSTAT_FIELDS:
        assert int(getattr(ta[2], f)) == int(getattr(ja[2], f)), f
    if K and occ == K:
        assert not t[1].valid.any()


def test_wire_width_and_empty_batches_match_jax():
    for d in (1, 12, 64):
        assert tq.wire_width(d) == jq.wire_width(d) == d + 10
    e = tq.empty_query_batch(5, 3)
    assert e.valid.shape == (5,) and not e.valid.any()
    rows = {k: np.arange(3) for k in ("qid", "kind", "part", "slot",
                                      "part2", "slot2", "issue")}
    rows["consistent"] = np.array([True, False, True])
    got = tq.query_batch_from_numpy(rows, 5, 3, "cpu")
    want = jq.query_batch_from_numpy(rows, 5, 3)
    assert_same(got, want, "batch")
    with pytest.raises(ValueError, match="overflow"):
        tq.query_batch_from_numpy(rows, 2, 3)


# ------------------------------------------------------ golden matrix

def port_model():
    _, jparams, _ = build_pipe()
    model = GraphSAGE(DIMS)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray,
                                                         jparams)))
    return model


def port_pipe(backend="kernel", query_cap=8, query_tick_cap=None,
              model=None):
    cfg = PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                         feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES,
                         query_cap=query_cap, query_tick_cap=query_tick_cap,
                         delivery_backend=backend,
                         window=twin.WindowConfig(kind=twin.STREAMING))
    return D3Pipeline(model or port_model(), cfg, device="cpu")


def port_run_config(edges, feats, driver, backend):
    """tests/test_query_plane.py:run_config, through the port."""
    pipe = port_pipe(backend)
    e_chunks, f_chunks = chunked(edges, feats)
    q = query_mix(edges)
    if driver == "tick":
        for ch, fe in zip(e_chunks[:-1], f_chunks[:-1]):
            pipe.tick(ch, fe)
        pipe.tick(e_chunks[-1], f_chunks[-1], queries=q)
        pipe.flush(max_ticks=96)
    else:
        q_chunks = [None] * (len(e_chunks) - 1) + [q]
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks),
                            query_chunks=q_chunks)
        pipe.flush_super(max_ticks=96, T=4)
    return pipe, canon(pipe.drain_answers())


@pytest.fixture(scope="module")
def golden_ref():
    """JAX's reference configuration (LocalRouter, per-tick, xla), built
    as tests/test_query_plane.py:golden_ref builds it."""
    edges, feats = make_stream()
    pipe, ref = run_config(edges, feats, None, "tick", "xla")
    assert len(ref["qid"]) == 4 and ref["ok"].all()
    return edges, feats, ref, pipe


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_golden_serving_matrix(golden_ref, driver, backend):
    edges, feats, ref, jpipe = golden_ref
    pipe, got = port_run_config(edges, feats, driver, backend)
    assert_answers_match(ref, got, f"port-{driver}-{backend}")
    if driver == "tick":       # the same driver: the same query counters
        for k in ("queries_admitted", "queries_answered", "queries_dropped",
                  "query_hold_ticks", "ticks", "reduce_msgs"):
            assert getattr(pipe.metrics, k) == getattr(jpipe.metrics, k), k


# ---------------------------------------------------------- behaviour

def test_stale_ok_bit_matches_read_nodes_same_tick():
    edges, feats = make_stream()
    pipe = port_pipe()
    pipe.run_stream(edges[:72], feats, tick_edges=24)
    pipe.tick(edges[72:], queries=[(1, tq.KIND_EMBED, 0, False),
                                   (2, tq.KIND_EMBED, 5, False)])
    oracle = pipe.read_nodes([0, 5])
    ans = canon(pipe.drain_answers())
    assert ans["qid"].tolist() == [1, 2]
    assert ans["tick"].tolist() == [pipe.now - 1] * 2
    assert oracle
    for i, vid in enumerate((0, 5)):
        assert bool(ans["ok"][i]) == (vid in oracle)
        if vid in oracle:
            np.testing.assert_array_equal(ans["vec"][i], oracle[vid])


def test_consistent_answers_match_static_oracle_after_flush(golden_ref):
    edges, feats, _, _ = golden_ref
    model = port_model()
    _, ans = port_run_config(edges, feats, "tick", "kernel")
    g, _ = build_snapshot(edges, feats, D_IN, N_NODES, "cpu")
    oracle = oracle_embeddings(model, g).numpy()
    u, v = int(edges[0, 0]), int(edges[0, 1])
    by = {int(q): i for i, q in enumerate(ans["qid"])}
    assert ans["ok"].all()
    np.testing.assert_allclose(ans["vec"][by[3]], oracle[5], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ans["score"][by[2]],
                               float(oracle[u] @ oracle[v]), rtol=1e-4)


def test_host_rejections_equal_jax():
    """Unknown vertices, ids outside the id space and qids >= 2**24 answer
    ok=False on the host without taking device slots."""
    edges, feats = make_stream()
    q = [(7, tq.KIND_EMBED, 0, False),                # unseen vid
         (8, tq.KIND_LINK, 0, 10 ** 6, False),        # out of range
         (2 ** 24, tq.KIND_EMBED, int(edges[0, 0]), False),   # qid too big
         (2 ** 24 - 1, tq.KIND_EMBED, int(edges[0, 0]), False)]
    _, _, jpipe = build_pipe()
    pipe = port_pipe()
    for p in (jpipe, pipe):
        p.tick(queries=q[:2])                         # nothing ingested
        p.run_stream(edges, feats, tick_edges=24)
        p.tick(queries=q[2:])
    want, got = canon(jpipe.drain_answers()), canon(pipe.drain_answers())
    for k in ("qid", "kind", "ok", "tick", "issue"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["qid"].tolist() == [7, 8, 2 ** 24 - 1, 2 ** 24]
    assert got["ok"].tolist() == [False, False, True, False]
    assert pipe.metrics.queries_admitted == jpipe.metrics.queries_admitted \
        == 1


def test_pending_table_overflow_answers_ok_false():
    """A full pending table answers the dropped records ok=False in the
    same tick (the JAX test's script, both packages)."""
    edges, feats = make_stream()
    _, _, jpipe = build_pipe(query_cap=1, query_tick_cap=8)
    pipe = port_pipe(query_cap=1, query_tick_cap=8)
    vid = int(edges[0, 0])
    qs = [(i, tq.KIND_EMBED, vid, True) for i in range(5)]
    out = []
    for p in (jpipe, pipe):
        p.run_stream(edges[:48], feats, tick_edges=24)
        p.tick(edges[48:72], queries=qs)
        first = canon(p.drain_answers())
        p.flush(max_ticks=96)
        out.append((first, canon(p.drain_answers()), p.metrics))
    (jf, js, jm), (tf, ts, tm) = out
    assert len(tf["qid"]) == 4 and not tf["ok"].any()
    assert set(tf["tick"].tolist()) == {2}     # the admission tick
    for a, b in ((tf, jf), (ts, js)):
        for k in ("qid", "kind", "ok", "tick", "issue"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(ts["qid"]) == 1 and ts["ok"].all()
    assert tm.queries_dropped == jm.queries_dropped == 4


def test_query_metrics_equal_jax():
    edges, feats = make_stream()
    _, _, jpipe = build_pipe()
    pipe = port_pipe()
    for p in (jpipe, pipe):
        p.run_stream(edges[:48], feats, tick_edges=24)
        p.tick(edges[48:72], queries=query_mix(edges))
        p.flush(max_ticks=96)
    for k in ("queries_admitted", "queries_answered", "queries_dropped",
              "query_hold_ticks", "ticks", "reduce_msgs", "broadcast_msgs",
              "emitted_total"):
        assert getattr(pipe.metrics, k) == getattr(jpipe.metrics, k), k
    assert pipe.metrics.queries_answered == 4
    assert pipe.metrics.query_hold_ticks > 0


@pytest.mark.parametrize("driver", ["tick", "super"])
def test_query_plane_off_or_idle_is_the_plain_program(driver):
    """query_cap=0 runs the program without the plane, and an enabled
    plane with no queries moves nothing: the same stats and state."""
    edges, feats = make_stream()
    model = port_model()
    runs = []
    for qc in (0, 8):
        pipe = port_pipe(query_cap=qc, model=model)
        if driver == "tick":
            pipe.run_stream(edges, feats, tick_edges=24)
            pipe.flush(max_ticks=96)
        else:
            pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
            pipe.flush_super(max_ticks=96, T=4)
        runs.append(pipe)
    a, b = runs
    assert a.queries.qid.shape == (4, 0)
    for k in ("ticks", "reduce_msgs", "broadcast_msgs", "cross_part_msgs",
              "emitted_total", "queries_answered"):
        assert getattr(a.metrics, k) == getattr(b.metrics, k), k
    assert torch.equal(a.sink, b.sink)
    with pytest.raises(ValueError, match="query_cap=0"):
        a.tick(queries=[(1, tq.KIND_EMBED, 0, False)])
    with pytest.raises(ValueError, match="query_cap > 0"):
        ServeSession(a)


def test_config_validation_equals_jax():
    from repro.core.pipeline import PipelineConfig as JaxConfig
    for kw, match in (({"query_cap": 0, "query_tick_cap": 8},
                       "query plane is disabled"),
                      ({"query_cap": 4, "query_tick_cap": 0},
                       "query_tick_cap=0")):
        for cls in (JaxConfig, PipelineConfig):
            with pytest.raises(ValueError, match=match):
                cls(**kw).validate()
    a = PipelineConfig(query_cap=8).capacities()
    b = JaxConfig(query_cap=8).capacities()
    assert a.query_admissions == b.query_admissions == 8 * 8
    assert PipelineConfig(query_cap=8, query_tick_cap=16).capacities(
    ).query_admissions == 16
    for n_dev in (1, 4):
        kw = dict(n_parts=8, feat_cap=8, query_cap=8, route_cap=4)
        assert PipelineConfig(**kw).capacities(n_dev).query_defer_rows == \
            JaxConfig(**kw).capacities(n_dev).query_defer_rows


def test_super_driver_reads_once_per_super_tick_with_queries():
    """With queries aboard, the super-tick driver still reads the device
    once per super-tick (stats, quiet counter, query counters and the T
    ticks' answers in one copy), and the query plane's stages read
    nothing back: no item(), bool(), int(), tolist() or numpy() of a
    tensor inside them. (The plain CPU delivery reads its run offsets;
    chip_smoke.py counts the whole program's syncs on the card.)"""
    from repro_torch.core import pipeline as tpipe
    edges, feats = make_stream()
    pipe = port_pipe()
    e_chunks, f_chunks = chunked(edges, feats)
    reads, staged = [], []
    stats_to_host = pipe._stats_to_host

    def counted(*a, **k):
        reads.append(1)
        return stats_to_host(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a query stage read a value to the host")

    def guarded(stage):
        def run(*a, **k):
            staged.append(stage.__name__)
            with mock.patch.object(torch.Tensor, "item", refuse), \
                    mock.patch.object(torch.Tensor, "__bool__", refuse), \
                    mock.patch.object(torch.Tensor, "__int__", refuse), \
                    mock.patch.object(torch.Tensor, "tolist", refuse), \
                    mock.patch.object(torch.Tensor, "numpy", refuse):
                return stage(*a, **k)
        return run

    pipe._stats_to_host = counted
    q = query_mix(edges)
    with mock.patch.object(tpipe, "query_admit_stage",
                           guarded(tpipe.query_admit_stage)), \
            mock.patch.object(tpipe, "query_answer_stage",
                              guarded(tpipe.query_answer_stage)):
        pipe.run_super_tick(e_chunks[:4], f_chunks[:4], T=4,
                            query_chunks=[None, q[:2], None, q[2:]])
        pipe.run_super_tick(e_chunks[4:], f_chunks[4:], T=4)
        pipe.flush_super(max_ticks=96, T=4)
    n_super = pipe.metrics.ticks // 4
    assert len(reads) == n_super
    assert len(staged) == 2 * pipe.metrics.ticks
    ans = canon(pipe.drain_answers())
    assert ans["qid"].tolist() == [1, 2, 3, 4] and ans["ok"].all()
    assert ans["issue"].tolist() == [1, 1, 3, 3]


# ------------------------------------------------------- ServeSession

def _script(sess_cls, pipe, driver, edges, feats, **kw):
    """One serving script: submissions before, during and after the
    stream, then a flush. Returns the session."""
    e_chunks, f_chunks = chunked(edges, feats)
    s = sess_cls(pipe, driver=driver, super_ticks=2, **kw)
    u, v = int(edges[0, 0]), int(edges[0, 1])
    s.submit_embed([0, 5, 31], consistent=False)
    s.submit_link([(u, v)], consistent=True)
    if driver == "tick":
        for i, (ch, fe) in enumerate(zip(e_chunks, f_chunks)):
            s.advance(ch, fe)
            if i == 1:
                s.submit_embed([u, v, 3], consistent=True)
                s.submit_link([(v, u), (u, 5)], consistent=False)
    else:
        for lo in range(0, len(e_chunks), 2):
            s.advance_super(e_chunks[lo:lo + 2], f_chunks[lo:lo + 2], T=2)
            if lo == 0:
                s.submit_embed([u, v, 3], consistent=True)
                s.submit_link([(v, u), (u, 5)], consistent=False)
    s.submit_embed(list(range(10)), consistent=False)
    s.step()
    s.flush()
    for _ in range(32):         # retries wait out their backoff
        if not s.outstanding:
            break
        s.step()
        s.flush()
    return s


def _session_equal(t, j):
    assert list(t.answers) == list(j.answers)
    for qid, a in j.answers.items():
        b = t.answers[qid]
        assert (b.qid, b.kind, b.ok, b.issue_tick, b.answer_tick) == \
            (a.qid, a.kind, a.ok, a.issue_tick, a.answer_tick), qid
        np.testing.assert_allclose(b.vec, a.vec, **VEC_TOL)
        np.testing.assert_allclose(b.score, a.score, rtol=1e-4, atol=1e-5)
    assert t.counters == j.counters
    assert t.outstanding == j.outstanding
    ts, js = t.latency_stats(), j.latency_stats()
    for k in ("answered", "adopted", "outstanding", "degraded", "retried",
              "shed", "retry_exhausted", "degraded_ticks",
              "staleness_ticks_p50", "staleness_ticks_max"):
        assert ts.get(k) == js.get(k), k


SESSION_CASES = {
    "plain": dict(),
    "shed": dict(shed_threshold=5),
    "retry": dict(max_retries=2, retry_backoff_ticks=1),
    "retained": dict(max_retained=6),
}


@pytest.mark.parametrize("name", list(SESSION_CASES))
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_serve_session_equals_jax(driver, name):
    edges, feats = make_stream()
    kw = SESSION_CASES[name]
    qtc = 2 if name == "retry" else None      # small budget: overflows
    qc = 1 if name == "retry" else 8
    _, _, jpipe = build_pipe(query_cap=qc, query_tick_cap=qtc)
    j = _script(JaxSession, jpipe, driver, edges, feats, **kw)
    t = _script(ServeSession, port_pipe(query_cap=qc, query_tick_cap=qtc),
                driver, edges, feats, **kw)
    _session_equal(t, j)
    assert t.outstanding == 0 and len(t.answers) > 0
    if name == "shed":
        assert t.counters["shed"] > 0
    if name == "retry":
        assert t.counters["retried"] > 0
    if name == "retained":
        assert len(t.answers) == 6


@pytest.mark.parametrize("driver", ["tick", "super"])
def test_serve_session_degrade_restore_equals_jax(driver):
    edges, feats = make_stream()
    e_chunks, f_chunks = chunked(edges, feats)
    out = []
    for cls, pipe in ((JaxSession, build_pipe()[2]), (ServeSession,
                                                      port_pipe())):
        s = cls(pipe, driver=driver, super_ticks=2)
        s.step(e_chunks[0], f_chunks[0])
        s.degrade("reshard")
        s.submit_embed([int(edges[0, 0])], consistent=True)
        s.submit_embed([int(edges[0, 1])], consistent=False)
        s.step(e_chunks[1], f_chunks[1])
        held = len(s._queue)
        s.restore_normal()
        for ch, fe in zip(e_chunks[2:], f_chunks[2:]):
            s.step(ch, fe)
        s.flush()
        out.append((s, held))
    (j, jh), (t, th) = out
    assert th == jh == 1 and t.degraded is None
    _session_equal(t, j)
    assert t.counters["degraded_ticks"] > 0 and t.outstanding == 0


def test_outstanding_counts_a_queued_query_twice_in_both_packages():
    """A fault of the JAX reference (ROADMAP Queue 3, R9), kept by the port
    so that shedding and its counters stay equal: `outstanding` adds
    `_meta` (every submitted, unanswered query) and `_queue` (the ones not
    yet admitted), so a queued query counts twice and `shed_threshold`
    sheds at half the backlog it names. Once admitted it counts once."""
    edges, feats = make_stream()
    for s in (JaxSession(build_pipe()[2], driver="tick"),
              ServeSession(port_pipe(), driver="tick")):
        s.advance(edges[:24], [(v, feats[v]) for v in range(N_NODES)])
        s.submit_embed([int(edges[0, 0])], consistent=True)
        assert s.outstanding == 2 and len(s._queue) == 1
        s.advance(edges[24:48])           # admitted, held on the device
        assert s.outstanding == 1 and not s._queue
        s.flush()
        assert s.outstanding == 0
