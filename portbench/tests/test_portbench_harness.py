"""The harness finds every cell's configuration, mix, system, reference and
metric readers by name; a small copy of each cell runs on the CPU and
comes out correct; the control and each fault a cell can have come out
not correct."""
import json

import pytest
import torch

from portbench import compare, harness, models
from portbench.tests.cells import CELLS, mix_of, run, small_bench
from portbench.yardstick import kernel_bytes


def test_every_name_resolves():
    assert_names_resolve(harness.load_bench())


def assert_names_resolve(bench):
    """Every metric has its reader, every cell its configuration, mix,
    system, reference and model module, every kernel entry its program
    function; each cell reports a per-layer metric that moves
    `events_per_s`."""
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for name in names:
        assert callable(harness.reader(name))
    for cell in bench["workloads"]:
        c, cfg, mix = harness.find_cell(bench, cell["name"])
        assert (harness.HERE / "systems" / f"{cfg['system']}.py").exists()
        assert (harness.HERE / "reference" / f"{cfg['reference']}.py"
                ).exists()
        model = models.load(cfg["model_module"])
        for fn in ("dims", "draw_weights", "build", "vertex_flops"):
            assert callable(getattr(model, fn)), fn
        assert mix["super_ticks"] >= 1
        for m in harness.metrics_of(bench, c, False):
            assert m["name"] in names
        # every e2e metric a cell reports moves with some per-layer one
        moved = {m["moves"] for m in harness.metrics_of(bench, c, True)}
        assert "events_per_s" in moved
    for entry in bench["configs"]:
        cfg = json.loads((harness.ROOT / entry["file"]).read_text())
        assert set(entry["reduced"]) <= set(cfg["source_values"])
    for entry in kernel_bytes.entries().values():
        kernel_bytes.target(entry)          # raises where it is gone


def test_every_cell_has_a_small_copy():
    missing = [w["name"] for w in harness.load_bench()["workloads"]
               if w["name"] not in CELLS]
    assert not missing, f"cells without tests/small/<cell>.json: {missing}"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_small_cell_is_correct(bench, cell):
    res = run(bench, cell)
    assert res["correct"], res["checks"]
    e2e = {m["name"] for m in harness.metrics_of(
        bench, {"name": cell}, False)}
    assert set(res["metrics"]) == e2e - {"peak_device_gib"}
    assert res["attempted"] > 0
    # a read fails unless it comes back ok; a stream event never fails;
    # every read names a vertex with an embedding, so none fails here
    ok = res["counts"].get("ok", res["attempted"])
    assert res["failed"] == res["attempted"] - ok == 0


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_small_cell_traced(bench, cell):
    res = run(bench, cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert "staging.host_share" in res["metrics"]


CONTROLS = [(c, "tf32") for c in sorted(CELLS.values())] + [
    ("small.train", "half_batch")]


@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_not_correct(bench, cell, control):
    res = run(bench, cell, control=control)
    assert not res["correct"], res["checks"]


def test_reads_not_ok_raise_the_tail():
    """Reads due: 100, answered at 1..100 ms. A read that is not ok
    counts as infinitely late, however fast it came back."""
    lat = [i / 1e3 for i in range(1, 101)]
    p95 = lambda ok: compare.nearest_rank(compare.tail_population(ok, 100),
                                          0.95)
    assert p95(lat) == 0.095
    assert p95(lat[3:]) == 0.098          # the three fastest not ok
    assert p95(lat[:97]) == 0.095         # the three slowest unanswered
    assert p95(lat[6:]) == float("inf")   # over 5% failed


def test_reads_not_ok_are_failed_and_beyond_the_tail(bench, monkeypatch):
    """Every answer made not ok where it is produced: each read is
    failed and the 95th percentile is infinite."""
    from dataclasses import replace

    from repro_torch.core import pipeline

    orig = pipeline.query_answer_stage

    def stage(*a, **k):
        qs, ans, st = orig(*a, **k)
        return qs, replace(ans, ok=torch.zeros_like(ans.ok)), st
    monkeypatch.setattr(pipeline, "query_answer_stage", stage)
    res = run(bench, "small.serve", trace=True)
    assert res["attempted"] > 0 and res["failed"] == res["attempted"]
    assert res["metrics"]["session.read_p95_ms"]["value"] == float("inf")
    assert res["metrics"]["session.ok_share"]["value"] == 0


# ---------------------------------------------------------------- faults
def _state_unchanged(mp):
    """Every layer's tick hands back the state it was given."""
    from repro_torch.core import pipeline

    orig = pipeline.layer_tick_body

    def body(layer, topo, state, *a, **k):
        _, *rest = orig(layer, topo, state, *a, **k)
        return (state, *rest)
    mp.setattr(pipeline, "layer_tick_body", body)


def _half_the_edges(mp):
    """The partitioner ingests every other edge of each tick."""
    from repro_torch.core.partitioner import StreamingPartitioner

    orig = StreamingPartitioner.ingest_edges
    mp.setattr(StreamingPartitioner, "ingest_edges",
               lambda self, edges: orig(self, edges[::2]))


def _half_the_edges_once_grown(mp):
    """Once the graph holds the set-up's edges (the first launch's), the
    partitioner ingests every other edge of each tick: set-up's checks
    see a sound engine, the window's ingest does not."""
    from repro_torch.core.partitioner import StreamingPartitioner

    orig, seen = StreamingPartitioner.ingest_edges, [0]
    mix = mix_of("sage-train.ingest")
    grown = mix["super_ticks"] * mix["edges"]["tick_edges"]

    def ingest(self, edges):
        seen[0] += len(edges)
        return orig(self, edges if seen[0] <= grown else edges[::2])
    mp.setattr(StreamingPartitioner, "ingest_edges", ingest)


def _answer_altered(mp):
    """Each answer's vector and score are nudged where they are made."""
    from dataclasses import replace

    from repro_torch.core import pipeline

    orig = pipeline.query_answer_stage

    def stage(*a, **k):
        qs, ans, st = orig(*a, **k)
        return qs, replace(ans, vec=ans.vec + 1e-2,
                           score=ans.score + 1e-2), st
    mp.setattr(pipeline, "query_answer_stage", stage)


def _train_step_unchanged(mp):
    """The training stage hands back the state it was given."""
    from repro_torch.core import pipeline

    mp.setattr(pipeline, "train_stage", lambda tcfg, head, lbw, lf, topo,
               sink, seen, ts, *a: ts)


def _train_half_batch(mp):
    """Half of each tick's labels are left out and a step fires on the
    rest (the loss's mean over them)."""
    from dataclasses import replace

    from repro_torch.core import pipeline

    orig = pipeline.train_stage

    def stage(tcfg, head, lbw, lf, topo, sink, seen, ts, lb, *a):
        valid = lb.valid & (torch.arange(lb.valid.shape[0]) % 2 == 0)
        half = replace(tcfg, batch_threshold=tcfg.batch_threshold // 2)
        return orig(half, head, lbw, lf, topo, sink, seen, ts,
                    replace(lb, valid=valid), *a)
    mp.setattr(pipeline, "train_stage", stage)


FAULTS = [("small.serve", _state_unchanged), ("small.serve", _half_the_edges),
          ("small.serve", _answer_altered),
          ("small.train", _state_unchanged), ("small.train", _half_the_edges),
          ("small.train", _half_the_edges_once_grown),
          ("small.train", _train_step_unchanged),
          ("small.train", _train_half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(bench, cell, fault, monkeypatch):
    fault(monkeypatch)
    try:
        res = run(bench, cell)
    except RuntimeError as e:       # a drain that never ends is a fault seen
        assert "terminate" in str(e)
        return
    assert not res["correct"], res["checks"]
