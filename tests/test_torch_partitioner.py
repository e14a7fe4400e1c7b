"""The port's streaming partitioner (repro_torch.core.partitioner) against
the JAX package's, and its capacity check.

The tables must be exactly equal for the same seed and stream; a slot
that would reach node_cap / edge_cap / repl_cap raises ValueError naming
the cap (the JAX reference silently spills into the next part's rows).
"""
import numpy as np
import pytest

from repro.core.partitioner import StreamingPartitioner as JaxPartitioner
from repro_torch.core import events as ev
from repro_torch.core.partitioner import StreamingPartitioner
from repro_torch.graph.graphs import powerlaw_edges


def _feed(part, edges, vids):
    rows = [part.ingest_edges(edges[lo:lo + 97])
            for lo in range(0, len(edges), 97)]
    masters = [part.locate_master(v) for v in vids]
    return rows, masters, part.drain_allocations()


@pytest.mark.parametrize("method", ["hdrf", "clda", "random"])
def test_tables_equal_jax(method):
    edges = powerlaw_edges(np.random.default_rng(3), 300, 1200)
    cold = [299, 298, 5]                  # feature-only vertices too
    a = JaxPartitioner(8, 300, method=method, seed=4, chunk=64)
    b = StreamingPartitioner(8, 300, method=method, seed=4, chunk=64)
    ra, ma, da = _feed(a, edges, cold)
    rb, mb, db = _feed(b, edges, cold)
    assert ma == mb
    for xa, xb in zip(ra + [da], rb + [db]):
        for dict_a, dict_b in zip(xa, xb):
            assert dict_a.keys() == dict_b.keys()
            for k in dict_a:
                np.testing.assert_array_equal(dict_a[k], dict_b[k])
    for name in ("degree", "replicas", "load", "master", "master_slot",
                 "next_vslot", "next_eslot"):
        np.testing.assert_array_equal(getattr(a.t, name),
                                      getattr(b.t, name), err_msg=name)
    assert a.t.slot_of == b.t.slot_of
    assert a.replication_factor() == b.replication_factor()


def test_powerlaw_edges_same_draws():
    from repro.graph.graphs import powerlaw_edges as jax_powerlaw
    np.testing.assert_array_equal(
        powerlaw_edges(np.random.default_rng(9), 500, 2000),
        jax_powerlaw(np.random.default_rng(9), 500, 2000))


@pytest.mark.parametrize("cap", ["node_cap", "edge_cap", "repl_cap"])
def test_capacity_overflow_raises(cap):
    """A hub touching every part needs one slot per part of each kind:
    capping one kind below the stream's demand must raise, naming it."""
    edges = powerlaw_edges(np.random.default_rng(0), 200, 2000)
    caps = {"node_cap": 10_000, "edge_cap": 10_000, "repl_cap": 10_000}
    caps[cap] = 8
    part = StreamingPartitioner(4, 200, **caps)
    with pytest.raises(ValueError, match=cap):
        part.ingest_edges(edges)


def test_capacity_exactly_full_is_accepted():
    """Slots 0 .. cap-1 are legal: a cap equal to the demand passes."""
    edges = powerlaw_edges(np.random.default_rng(0), 200, 600)
    free = StreamingPartitioner(4, 200)
    free.ingest_edges(edges)
    tight = StreamingPartitioner(
        4, 200, node_cap=int(free.t.next_vslot.max()),
        edge_cap=int(free.t.next_eslot.max()),
        repl_cap=int(free._repl_counters.max()))
    tight.ingest_edges(edges)
    np.testing.assert_array_equal(tight.t.master, free.t.master)


def test_batch_overflow_raises():
    rows = {"part": np.zeros(5), "slot": np.zeros(5),
            "is_master": np.zeros(5, bool)}
    with pytest.raises(ValueError, match="vertex batch overflow"):
        ev.vertex_batch_from_numpy(rows, 4)
