"""The launch log and the program's profiler ranges (telemetry/spans.py),
on the CPU at tests/test_torch_telemetry.py's sizes (32 nodes, dims (8,
12, 12), 4 parts):

  * each driver call (run_super_tick, ServeSession.advance_super, tick,
    flush_super) appends one record a launch, its ingest counters equal
    to what was staged, its upload counters to the bytes copied to the
    device, the bytes of the valid rows and the bytes of the lanes built;
  * the five phases sum to the record's wall, and StreamMetrics'
    host_seconds and wall_seconds are the records' stage + upload and
    walls;
  * the ring keeps the newest RING records, oldest first (the recorder
    alone);
  * under torch.profiler the `d3.*` ranges nest launch > phases > tick >
    layer stages; with no profiler no record_function is entered; the
    state, stats and answers are bit-equal with the profiler on and off.
"""
import json
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim as topt
from repro_torch.core import events
from repro_torch.core import windowing as win
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.core.tick import SCALAR_FIELDS
from repro_torch.core.train_plane import TrainConfig
from repro_torch.graph.sage import GraphSAGE
from repro_torch.serve.query import KIND_EMBED, KIND_LINK
from repro_torch.serve.session import ServeSession
from repro_torch.telemetry import spans

N_NODES, D_IN, DIMS = 32, 8, (8, 12, 12)
CAPS = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES)
T = 4


def make_stream(seed=0, n_edges=100):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D_IN).astype(np.float32)
             for v in range(N_NODES)}
    return edges, feats


def make_pipe(train=False, query_cap=8):
    """A pipeline with the query plane (and, with train, the training
    plane) on."""
    kw = dict(CAPS, query_cap=query_cap,
              window=win.WindowConfig(kind=win.STREAMING))
    if not train:
        return D3Pipeline(GraphSAGE(DIMS), PipelineConfig(**kw),
                          device="cpu")
    return D3Pipeline(
        GraphSAGE(DIMS, n_classes=4), PipelineConfig(**kw, train_cap=32),
        device="cpu", train=TrainConfig(optimizer=topt.sgd(), lr=0.05,
                                        batch_threshold=6))


def chunks(pipe, seed=0):
    """Ten ticks of 24 edges, each vertex's feature with its first edge."""
    edges, feats = make_stream(seed, n_edges=250)
    return pipe.chunk_stream(edges, feats, 24)


def labels_of(e_chunks):
    return [[(int(v), int(v) % 4) for v in np.unique(e)[:5]]
            for e in e_chunks]


def new_records(before: int) -> list:
    return [r for r in spans.records() if r["seq"] >= before]


def next_seq() -> int:
    recs = spans.records()
    return recs[-1]["seq"] + 1 if recs else 0


def assert_phases_sum(rec):
    assert abs(sum(rec["spans"][p] for p in spans.PHASES)
               - rec["wall_s"]) < 1e-9
    assert all(rec["spans"][p] >= 0 for p in spans.PHASES)


# ------------------------------------------------------- one record a call

def _run_super(pipe, e, f):
    q = [(1, KIND_EMBED, int(e[0][0, 0]), False),
         (2, KIND_LINK, int(e[0][0, 0]), int(e[0][0, 1]), False)]
    lab = labels_of(e[:T])
    pipe.run_super_tick(e[:T], f[:T], T=T, query_chunks=[q, None, q[:1]],
                        label_chunks=lab)
    return dict(edges=sum(len(c) for c in e[:T]),
                feats=sum(len(c) for c in f[:T]), queries=3,
                labels=sum(map(len, lab))), 1


def _advance_super(pipe, e, f):
    sess = ServeSession(pipe, driver="super", super_ticks=T)
    sess.submit_embed([int(e[0][0, 0]), int(e[0][0, 1])])
    sess.submit_link([(int(e[0][0, 0]), int(e[0][1, 0]))])
    sess.advance_super(e[:T], f[:T], T=T)
    return dict(edges=sum(len(c) for c in e[:T]),
                feats=sum(len(c) for c in f[:T]), queries=3, labels=0), 1


def _tick(pipe, e, f):
    lab = labels_of(e[:1])[0]
    pipe.tick(e[0], f[0], queries=[(7, KIND_EMBED, int(e[0][0, 0]), False)],
              labels=lab)
    return dict(edges=len(e[0]), feats=len(f[0]), queries=1,
                labels=len(lab)), 1


def _flush_super(pipe, e, f):
    ran = pipe.flush_super(max_ticks=64, T=T)
    return dict(edges=0, feats=0, queries=0, labels=0), (ran + T - 1) // T


DRIVERS = {"run_super_tick": _run_super, "advance_super": _advance_super,
           "tick": _tick, "flush_super": _flush_super}
# flush_super drains what a launch before it left
PREP = {"flush_super": lambda pipe, e, f: pipe.run_super_tick(e[:T], f[:T],
                                                              T=T)}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_each_driver_call_appends_one_record_a_launch(driver):
    pipe = make_pipe(train=driver in ("run_super_tick", "tick"))
    e, f = chunks(pipe)
    if driver in PREP:
        PREP[driver](pipe, e, f)
    start = next_seq()
    tick0 = pipe.now
    host0, wall0 = pipe.metrics.host_seconds, pipe.metrics.wall_seconds
    want, n = DRIVERS[driver](pipe, e, f)
    recs = new_records(start)
    assert len(recs) == n > 0
    for r in recs:
        assert r["kind"] == "launch" and r["pipeline"] == pipe.span_id
        assert r["T"] == (1 if driver == "tick" else T)
        assert not r["profiled"]
        assert_phases_sum(r)
    assert [r["tick"] for r in recs] == [tick0 + i * recs[0]["T"]
                                         for i in range(n)]
    got = {k: sum(r["counts"][k] for r in recs) for k in want}
    assert got == want
    if want["edges"]:
        assert recs[0]["spans"]["stage.partition"] > 0
    if want["queries"]:
        assert recs[0]["spans"]["stage.queries"] > 0
    if want["labels"]:
        assert recs[0]["spans"]["stage.labels"] > 0
    if driver == "tick":
        assert recs[0]["spans"]["upload"] == 0.0
        assert recs[0]["counts"]["upload.bytes"] == 0
    m = pipe.metrics
    assert abs(m.host_seconds - host0 - sum(
        r["spans"]["stage"] + r["spans"]["upload"] for r in recs)) < 1e-9
    assert abs(m.wall_seconds - wall0
               - sum(r["wall_s"] for r in recs)) < 1e-9


def test_upload_counters_are_the_copied_bytes():
    """Over every stack of a launch: upload.bytes is what is copied to the
    device (each tick's valid rows of every field, each field's rows
    8-byte aligned, after the two int64 [T] columns of tick ends and
    shifts), upload.live_bytes the bytes of the valid rows and
    upload.lane_bytes the bytes of the padded lanes built there."""
    pipe = make_pipe(train=True)
    e, f = chunks(pipe)
    seen = {"bytes": 0, "live": 0, "lanes": 0, "calls": 0}
    orig = events.stack_batches

    def stack(batches, device):
        valid = np.stack([b.valid for b in batches])
        seen["bytes"] += 16 * len(batches)
        for name in batches[0].__dataclass_fields__:
            a = np.stack([getattr(b, name) for b in batches])
            rows = a[valid].nbytes
            seen["bytes"] += -(-rows // 8) * 8
            seen["live"] += rows
            seen["lanes"] += a.nbytes
        seen["calls"] += 1
        return orig(batches, device)

    start = next_seq()
    with mock.patch.object(events, "stack_batches", stack):
        pipe.run_super_tick(e[:T], f[:T], T=T, label_chunks=labels_of(e[:T]),
                            query_chunks=[[(1, KIND_EMBED, int(e[0][0, 0]),
                                            False)]])
    (rec,) = new_records(start)
    assert seen["calls"] == 6         # edge, repl, vertex, feat, query, label
    assert rec["counts"]["upload.bytes"] == seen["bytes"]
    assert rec["counts"]["upload.live_bytes"] == seen["live"]
    assert rec["counts"]["upload.lane_bytes"] == seen["lanes"]
    assert 0 < seen["live"] < seen["bytes"] < seen["lanes"]


def test_metrics_clocks_are_the_records():
    """Over a mixed run (both drivers, a drain), host_seconds is the
    records' stage + upload and wall_seconds their walls, each record's
    phases summing to its wall."""
    pipe = make_pipe()
    e, f = chunks(pipe)
    start = next_seq()
    pipe.run_super_tick(e[:T], f[:T], T=T)
    pipe.tick(e[T], f[T])
    pipe.flush_super(max_ticks=64, T=T)
    pipe.flush(max_ticks=64)
    recs = new_records(start)
    assert len(recs) >= 4
    for r in recs:
        assert_phases_sum(r)
    m = pipe.metrics
    assert abs(m.host_seconds - sum(r["spans"]["stage"] + r["spans"]["upload"]
                                    for r in recs)) < 1e-9
    assert abs(m.wall_seconds - sum(r["wall_s"] for r in recs)) < 1e-9
    assert m.ticks == sum(r["T"] for r in recs)


def test_build_record():
    start = next_seq()
    pipe = make_pipe()
    (rec,) = new_records(start)
    assert rec["kind"] == "build" and rec["pipeline"] == pipe.span_id
    assert rec["spans"] == {"pipeline.build": rec["wall_s"]}
    assert rec["wall_s"] > 0 and rec["counts"] == {}
    assert make_pipe().span_id > pipe.span_id


# ---------------------------------------------------------- the recorder

def test_ring_keeps_the_newest_records():
    spans.clear()
    try:
        for i in range(spans.RING + 1):
            with spans.launch(-1, i, 1) as rec:
                spans.count("edges", i)
                rec.phase("dispatch")
        recs = spans.records()
        assert len(recs) == spans.RING
        assert [r["tick"] for r in recs] == list(range(1, spans.RING + 1))
        assert [r["counts"]["edges"] for r in recs] == [r["tick"]
                                                        for r in recs]
        seqs = [r["seq"] for r in recs]
        assert seqs == sorted(seqs)
        recs[0]["spans"]["stage"] = -1.0      # plain copies
        assert spans.records()[0]["spans"]["stage"] >= 0
    finally:
        spans.clear()
    assert spans.records() == []


def test_outside_a_launch_spans_and_counts_do_nothing():
    spans.clear()
    with spans.span("stage.partition"):
        pass
    spans.count("edges", 3)
    spans.phase("wait")
    assert spans.current() is None and spans.records() == []
    with spans.launch(-1, 0, 2) as rec:
        assert spans.current() is rec
        with spans.span("stage.pack"):
            spans.count("upload.bytes", 5)
        spans.phase("upload")
        spans.phase("dispatch")
    assert spans.current() is None
    (r,) = spans.records()
    assert r["counts"]["upload.bytes"] == 5 and r["spans"]["stage.pack"] > 0
    assert set(spans.PHASES) <= set(r["spans"])
    assert_phases_sum(r)
    spans.clear()


# ------------------------------------------------------- profiler ranges

def _intervals(events_, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events_
            if e.get("name") == name and e.get("ph") == "X"]


def _inside(inner, outer) -> bool:
    return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in outer)
               for i0, i1 in inner)


def _profiled_launch(tmp_path):
    pipe = make_pipe(train=True)
    e, f = chunks(pipe)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run_super_tick(e[:T], f[:T], T=T, label_chunks=labels_of(e[:T]))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_profiler_ranges_nest(tmp_path):
    start = next_seq()
    ev = _profiled_launch(tmp_path)
    build, rec = new_records(start)
    assert rec["profiled"] and not build["profiled"]
    names = {e["name"] for e in ev if e.get("name", "").startswith("d3.")
             and e.get("cat") == "user_annotation"}
    ranges = {n: _intervals(ev, n) for n in names}
    assert len(ranges["d3.launch"]) == 1
    for phase in spans.PHASES:
        assert _inside(ranges["d3." + phase], ranges["d3.launch"]), phase
    assert _inside(ranges["d3.stage.partition"], ranges["d3.stage"])
    assert _inside(ranges["d3.stage.labels"], ranges["d3.stage"])
    assert len(ranges["d3.tick"]) == T
    assert _inside(ranges["d3.tick"], ranges["d3.dispatch"])
    for sub in ("topology", "query_admit", "sink", "query_answer", "train"):
        assert len(ranges["d3.tick." + sub]) == T, sub
        assert _inside(ranges["d3.tick." + sub], ranges["d3.tick"]), sub
    for sub in ("round_a", "round_b", "rmi_apply", "forward"):
        got = ranges["d3.layer." + sub]
        assert len(got) == T * len(DIMS[1:]), sub
        assert _inside(got, ranges["d3.tick"]), sub


class _Counting:
    """A stand-in record_function that counts its entries."""
    entered = 0

    def __init__(self, name):
        self.inner = _REAL_RF(name)

    def __enter__(self):
        _Counting.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


_REAL_RF = torch.autograd.profiler.record_function


def _every_driver(pipe):
    e, f = chunks(pipe)
    sess = ServeSession(pipe, driver="super", super_ticks=T)
    sess.submit_embed([int(e[0][0, 0])])
    sess.advance_super(e[:T], f[:T], T=T)
    pipe.run_super_tick(e[T:2 * T], f[T:2 * T], T=T)
    pipe.tick(e[2 * T], f[2 * T])
    pipe.flush_super(max_ticks=64, T=T)


def test_no_profiler_enters_no_record_function():
    _Counting.entered = 0
    with mock.patch.object(torch.autograd.profiler, "record_function",
                           _Counting):
        _every_driver(make_pipe())
        assert _Counting.entered == 0
        # the control: the same calls under the profiler enter it
        with profile(activities=[ProfilerActivity.CPU]):
            _every_driver(make_pipe())
    assert _Counting.entered > 0


def test_profiler_changes_nothing():
    """Two pipelines, one driven under the profiler: every stat, answer
    and state tensor bit-equal."""
    def drive(pipe):
        e, f = chunks(pipe)
        q = [(1, KIND_EMBED, int(e[0][0, 0]), False),
             (2, KIND_LINK, int(e[0][0, 0]), int(e[0][0, 1]), True)]
        lab = labels_of(e)
        out = [pipe.run_super_tick(e[:T], f[:T], T=T, query_chunks=[q],
                                   label_chunks=lab[:T])[0],
               pipe.tick(e[T], f[T], labels=lab[T])]
        out.append(pipe.run_super_tick(T=T)[0])
        return out, pipe.drain_answers()

    off = make_pipe(train=True)
    s_off, a_off = drive(off)
    on = make_pipe(train=True)
    with profile(activities=[ProfilerActivity.CPU]):
        s_on, a_on = drive(on)
    for x, y in zip(s_on, s_off):
        for sx, sy in zip(x, y):
            for f in SCALAR_FIELDS:
                assert int(getattr(sx, f)) == int(getattr(sy, f)), f
            assert torch.equal(sx.busy, sy.busy)
    assert a_on.keys() == a_off.keys() and len(a_on["qid"]) > 0
    for k in a_on:
        np.testing.assert_array_equal(a_on[k], a_off[k], err_msg=k)
    assert torch.equal(on.sink, off.sink)
    for la, lb in zip(on.states, off.states):
        for f in la.__dataclass_fields__:
            assert torch.equal(getattr(la, f), getattr(lb, f)), f
    for k, v in on.train_stats().items():
        assert v == off.train_stats()[k], k
