"""The five readers of the program's launch log, on synthetic records and
on a small traced cell: each keeps only the newest pipeline's loaded,
unprofiled launches and takes their median (the live share sums before
it divides), and reads None where there is nothing to read, a program
without the launch log included."""
import math
import sys

import pytest

from portbench import harness
from portbench.tests.cells import CELLS, run, small_bench
from portbench.yardstick import program_spans

READERS = ("staging.partition_us_per_edge", "staging.upload_ms",
           "staging.upload_live_share", "driver.dispatch_ms_per_tick",
           "setup.pipeline_build_s")


def launch(pipeline, edges, partition, upload, dispatch, T=8,
           live=0, total=0, profiled=False):
    return {"kind": "launch", "pipeline": pipeline, "seq": 0, "tick": 0,
            "T": T, "profiled": profiled, "wall_s": 0.0,
            "spans": {"stage": 0.0, "upload": upload, "dispatch": dispatch,
                      "wait": 0.0, "post": 0.0,
                      "stage.partition": partition},
            "counts": {"edges": edges, "feats": 0, "queries": 0,
                       "labels": 0, "upload.bytes": total,
                       "upload.live_bytes": live}}


def build(pipeline, seconds):
    return {"kind": "build", "pipeline": pipeline, "seq": 0, "tick": 0,
            "T": 0, "profiled": False, "wall_s": seconds,
            "spans": {"pipeline.build": seconds}, "counts": {}}


# an older pipeline, then the newest with three kept launches beside a
# drain (no edges) and a profiled launch, each of which would move every
# median if it were kept
RECORDS = [
    build(0, 9.0),
    launch(0, 100, 1.0, 1.0, 1.0, live=1, total=1),
    build(1, 2.5),
    launch(1, 1000, 0.020, 0.2, 0.4, live=10, total=1000),
    launch(1, 2000, 0.030, 0.1, 0.8, live=990, total=1000),
    launch(1, 1000, 0.025, 0.3, 1.6, live=0, total=2000),
    launch(1, 0, 0.0, 5.0, 5.0, live=0, total=10 ** 6),
    launch(1, 1000, 5.0, 5.0, 5.0, live=10 ** 6, total=10 ** 6,
           profiled=True),
]
WANT = {"staging.partition_us_per_edge": 20.0,     # 20, 15, 25 us
        "staging.upload_ms": 200.0,
        # 1,000 of 4,000 bytes; the mean of the ratios would read 33.3
        "staging.upload_live_share": 25.0,
        "driver.dispatch_ms_per_tick": 100.0,      # 50, 100, 200 ms / 8
        "setup.pipeline_build_s": 2.5}


@pytest.mark.parametrize("name", READERS)
def test_reader_keeps_the_newest_loaded_unprofiled_launches(name,
                                                           monkeypatch):
    monkeypatch.setattr(program_spans, "_records", lambda: RECORDS)
    assert [r["counts"]["edges"] for r in program_spans.launches()] == [
        1000, 2000, 1000]
    assert harness.reader(name)(None) == pytest.approx(WANT[name],
                                                       rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_on_an_empty_ring(name, monkeypatch):
    monkeypatch.setattr(program_spans, "_records", lambda: [])
    assert harness.reader(name)(None) is None
    # a ring of drains and profiled launches alone keeps nothing
    if name != "setup.pipeline_build_s":
        monkeypatch.setattr(program_spans, "_records",
                            lambda: [r for r in RECORDS
                                     if r["kind"] == "launch"
                                     and (r["profiled"]
                                          or not r["counts"]["edges"])])
        assert harness.reader(name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_launch_log_reads_none(name, monkeypatch):
    """A program with no `repro_torch.telemetry.spans` (the parent of the
    launch log): every reader returns None and raises nothing."""
    import repro_torch.telemetry as telemetry
    monkeypatch.delattr(telemetry, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry.spans", None)
    assert harness.reader(name)(None) is None


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_a_traced_small_cell_reports_all_five(bench, cell):
    res = run(bench, cell, trace=True)
    assert res["correct"], res["checks"]
    for name in READERS:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name
    assert 0 < res["metrics"]["staging.upload_live_share"]["value"] < 100
