"""The super-tick upload (`events.stack_batches`): only each tick's valid
rows travel, and the padded `[T, cap, ...]` lanes built on the device are
bit-equal to `np.stack` of the host batches, for every batch class at
n = 0, 0 < n < cap and n = cap, at T = 1 and over a launch of T = 8 with
mixed n. A batch whose `valid` is not a prefix is refused.

The `cuda` case runs the same launches through the pinned, non-blocking
copy on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_upload.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import events as ev
from repro_torch.serve.query import query_batch_from_numpy

CAP, D = 16, 5


def _ints(rng, n):
    return rng.integers(-2**40, 2**40, n)


def _edge(rng, n):
    return ev.edge_batch_from_numpy(
        {k: _ints(rng, n) for k in ("part", "edge_slot", "src_slot",
                                    "dst_slot", "dst_master_part",
                                    "dst_master_slot")}, CAP)


def _repl(rng, n):
    return ev.repl_batch_from_numpy(
        {k: _ints(rng, n) for k in ("part", "repl_slot", "master_slot",
                                    "rep_part", "rep_slot")}, CAP)


def _vertex(rng, n):
    return ev.vertex_batch_from_numpy(
        {"part": _ints(rng, n), "slot": _ints(rng, n),
         "is_master": rng.random(n) < 0.5}, CAP)


def _feat(rng, n):
    f = rng.normal(size=(n, D)).astype(np.float32)
    f[::3, 0] = -0.0                  # the sign of zero survives the copy
    return ev.feat_batch_from_numpy(_ints(rng, n), _ints(rng, n), f, CAP, D)


def _label(rng, n):
    return ev.label_batch_from_numpy(_ints(rng, n), _ints(rng, n),
                                     rng.integers(0, 41, n), CAP)


def _query(rng, n):
    rows = {k: _ints(rng, n) for k in ("qid", "kind", "part", "slot",
                                       "part2", "slot2", "issue")}
    rows["consistent"] = rng.random(n) < 0.5
    return query_batch_from_numpy(rows, CAP, D)


BUILDERS = {"edge": _edge, "repl": _repl, "vertex": _vertex,
            "feat": _feat, "label": _label, "query": _query}
LAUNCHES = {"T1-empty": [0], "T1-partial": [7], "T1-full": [CAP],
            "T8-mixed": [0, 3, CAP, 1, 0, CAP - 1, 9, CAP]}


def _check_launch(kind, ns, device):
    rng = np.random.default_rng([len(ns), *ns])
    batches = [BUILDERS[kind](rng, n) for n in ns]
    got = ev.stack_batches(batches, device)
    assert type(got) is type(batches[0])
    for f in dataclasses.fields(got):
        want = np.stack([getattr(b, f.name) for b in batches])
        lane = getattr(got, f.name)
        assert lane.device.type == torch.device(device).type
        assert lane.dtype == torch.from_numpy(want).dtype, f.name
        assert tuple(lane.shape) == want.shape, f.name
        host = lane.cpu()
        assert torch.equal(host, torch.from_numpy(want)), f.name
        assert host.numpy().tobytes() == want.tobytes(), f.name


@pytest.mark.parametrize("launch", sorted(LAUNCHES))
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_stack_batches_is_the_stacked_host_batches(kind, launch):
    _check_launch(kind, LAUNCHES[launch], "cpu")


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_stack_batches_refuses_a_valid_column_that_is_not_a_prefix(kind):
    rng = np.random.default_rng(1)
    good = BUILDERS[kind](rng, 4)
    valid = good.valid.copy()
    valid[1] = False                       # 3 rows, not the first 3
    bad = dataclasses.replace(good, valid=valid)
    with pytest.raises(ValueError, match="not a prefix"):
        ev.stack_batches([good, bad], "cpu")


@pytest.mark.cuda
def test_stack_batches_on_the_card_is_the_stacked_host_batches():
    if not torch.cuda.is_available():
        pytest.skip("the pinned upload needs an NVIDIA GPU")
    for kind in sorted(BUILDERS):
        for launch in sorted(LAUNCHES):
            _check_launch(kind, LAUNCHES[launch], "cuda")
