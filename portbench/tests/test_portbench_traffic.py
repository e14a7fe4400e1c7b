"""Mixes repeat by seed and differ across seeds; the ingest mixes draw bit
for bit what their pinned digests say."""
import hashlib

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.cells import mix_of
from portbench.traffic.generator import Traffic, load_mix

SERVE_MIX = mix_of("sage.ingest")
TRAIN_MIX = mix_of("sage-train.ingest")


def _draw(mix, seed, n_classes=0):
    tr = Traffic(mix, 3000, 16, seed, torch.device("cpu"), n_classes)
    launches = [tr.next_launch() for _ in range(3)]
    edges = np.concatenate([np.concatenate(e) for e, _ in launches])
    feats = [v for _, f in launches for c in f for v, _ in c]
    out = {"edges": edges, "feat_vids": np.asarray(feats),
           "feats": tr.feats}
    if "queries" in mix:
        due, is_link, uni = tr.query_schedule(2.0)
        out.update(due=due, is_link=is_link,
                   picks=tr.pick(uni[:, 0]))
    if "labels" in mix:
        out["labels"] = np.asarray(tr.labels_for_launch(8))
    return out


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_mixes_repeat_by_seed_and_differ_across_seeds():
    for mix, nc in ((SERVE_MIX, 0), (TRAIN_MIX, 5)):
        a, b = _draw(mix, 2 ** 31 + 7, nc), _draw(mix, 2 ** 31 + 7, nc)
        c = _draw(mix, 12, nc)
        assert _same(a, b)
        assert not any(np.array_equal(a[k], c[k]) for k in
                       ("edges", "feats", "feat_vids"))


def test_features_arrive_once_with_first_edge():
    tr = Traffic(SERVE_MIX, 3000, 4, 5, torch.device("cpu"))
    seen = set()
    for _ in range(3):
        e, f = tr.next_launch()
        for chunk, fe in zip(e, f):
            vids = [v for v, _ in fe]
            assert not seen & set(vids)
            seen |= set(vids)
            assert set(np.unique(chunk)) <= seen
    assert seen == set(tr.ingested().tolist())


def test_reads_pick_ingested_vertices():
    """Reads name the vertices that the warm launches ingested, uniformly,
    the same set whatever was handed out since; none before those
    launches are out."""
    tr = Traffic(SERVE_MIX, 3000, 4, 5, torch.device("cpu"))
    warm = SERVE_MIX["warm_super_ticks"]
    with pytest.raises(ValueError):
        tr.pick(np.zeros(1))
    for _ in range(warm):
        tr.next_launch()
    pool = tr.ingested()
    u = np.random.default_rng(0).uniform(size=20000)
    picks = tr.pick(u)
    for _ in range(2):
        tr.next_launch()
    assert len(tr.ingested()) > len(pool)
    assert np.array_equal(tr.pick(u), picks)
    assert set(picks) == set(pool)
    due, is_link, uni = tr.query_schedule(10.0)
    assert len(due) == round(SERVE_MIX["queries"]["rate_per_s"] * 10)
    assert is_link.sum() == len(due) // 8
    assert np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 10
    # uniform: no vertex is read far more often than the others
    counts = np.bincount(picks, minlength=3000)[pool]
    assert counts.max() < 3 * len(picks) / len(pool)


def test_the_benchmarks_mixes_load():
    for cell in harness.load_bench()["workloads"]:
        mix = load_mix(cell["traffic"])
        assert mix["super_ticks"] >= 1 and mix["edges"]["tick_edges"] > 0


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# sha256 of the draws below, pinned so that a change to the generator
# cannot change what the benchmark's ingest cells draw unseen
INGEST_DIGESTS = {
    "ingest_serve":
        "32b3cc98d3728ec9d066a7d00e1e53b5f4c46dec8dec6676f94a227703a39097",
    "ingest_train":
        "1a3523f517d31f960db3e58e7829eca0368b457e126ac68e135205019c8533d4"}


@pytest.mark.parametrize("name", sorted(INGEST_DIGESTS))
def test_ingest_mixes_draw_their_pinned_digests(name):
    """Three launches' edges and new vertices, every feature row, the
    read schedule and picks, a launch of labels: bit for bit."""
    nc = 5 if name == "ingest_train" else 0
    tr = Traffic(load_mix(name), 3000, 16, 2 ** 31 + 7,
                 torch.device("cpu"), nc)
    arrs = []
    for _ in range(3):
        e, f = tr.next_launch()
        arrs += [np.concatenate(e),
                 np.asarray([v for c in f for v, _ in c], np.int64)]
    arrs.append(tr.feats)
    if "queries" in tr.mix:
        due, is_link, uni = tr.query_schedule(2.0)
        arrs += [due, is_link, tr.pick(uni[:, 0])]
    if nc:
        arrs.append(np.asarray(tr.labels_for_launch(8)))
    assert digest(*arrs) == INGEST_DIGESTS[name]
