"""The paper's explosion-factor and balance metrics and the synthetic
streams of the port (core/explosion.py, data/streams.py, the partitioner's
load_imbalance, D3Pipeline.physical_busy_per_layer, StreamMetrics.
throughput) against the JAX package's.

Tolerances: every value is host numpy arithmetic, so equality is exact:
the same integers, the same float64 vectors, the same arrays from the same
generator calls.
"""
import numpy as np
import jax
import pytest

from repro.core import explosion as jexp
from repro.core import windowing as jwin
from repro.core.pipeline import D3Pipeline as JaxPipeline
from repro.core.pipeline import PipelineConfig as JaxConfig
from repro.core.pipeline import StreamMetrics as JaxMetrics
from repro.data import streams as jstreams
from repro.graph.sage import GraphSAGE as JaxSAGE
from repro_torch.convert import params_from_numpy
from repro_torch.core import explosion as texp
from repro_torch.core import windowing as twin
from repro_torch.core.pipeline import (D3Pipeline, PipelineConfig,
                                       StreamMetrics)
from repro_torch.data import streams as tstreams
from repro_torch.graph.sage import GraphSAGE

GRID = [(p, lam, L, mp) for p in (1, 2, 3) for lam in (0.5, 1.0, 1.5, 2.0)
        for L in (1, 2, 4) for mp in (4, 8, 64)]


@pytest.mark.parametrize("p,lam,L,mp", GRID)
def test_explosion_functions_equal_jax(p, lam, L, mp):
    assert texp.layer_parallelisms(p, lam, L, mp) == \
        jexp.layer_parallelisms(p, lam, L, mp)
    logical = np.arange(3 * mp)
    for par in texp.layer_parallelisms(p, lam, L, mp):
        np.testing.assert_array_equal(
            texp.physical_part(logical, par, mp),
            jexp.physical_part(logical, par, mp))
        assert texp.physical_part(int(logical[-1]), par, mp) == \
            jexp.physical_part(int(logical[-1]), par, mp)
        rng = np.random.default_rng(p * 100 + L)
        busy = rng.integers(0, 50, mp)
        got = texp.physical_busy(busy, par, mp)
        np.testing.assert_array_equal(got, jexp.physical_busy(busy, par, mp))
        assert got.sum() == busy.sum() and got.shape == (par,)
        assert texp.imbalance_factor(got) == jexp.imbalance_factor(got)
    assert texp.imbalance_factor(np.zeros(mp)) == 0.0
    assert texp.imbalance_factor(np.zeros(mp)) == jexp.imbalance_factor(
        np.zeros(mp))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("burstiness", [0.0, 0.3])
def test_streams_equal_jax(seed, burstiness):
    kw = dict(seed=seed, n_nodes=200, n_edges=1500, d_feat=6,
              burstiness=burstiness)
    a, b = tstreams.temporal_stream(**kw), jstreams.temporal_stream(**kw)
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert a.n_nodes == b.n_nodes and set(a.feats) == set(b.feats)
    for v in b.feats:
        np.testing.assert_array_equal(a.feats[v], b.feats[v])
    for x, y in zip(tstreams.edge_stream(a, 128), jstreams.edge_stream(b, 128),
                    strict=True):
        np.testing.assert_array_equal(x, y)
    for lag in (0, 2):
        got = list(tstreams.feature_stream(a, 128, feature_lag=lag))
        want = list(jstreams.feature_stream(b, 128, feature_lag=lag))
        assert [[v for v, _ in t] for t in got] == \
            [[v for v, _ in t] for t in want]
        for t_got, t_want in zip(got, want):
            for (_, x), (_, y) in zip(t_got, t_want):
                np.testing.assert_array_equal(x, y)


CAPS = dict(n_parts=8, node_cap=64, edge_cap=256, repl_cap=256,
            feat_cap=128, edge_tick_cap=64, max_nodes=200)


@pytest.fixture(scope="module")
def streamed():
    """The same temporal stream through the JAX and the port pipeline."""
    s = tstreams.temporal_stream(seed=3, n_nodes=200, n_edges=600, d_feat=8)
    jmodel = JaxSAGE((8, 12, 12))
    jparams = jmodel.init(jax.random.key(0))
    out = {}
    for lam in (1.0, 1.5, 2.0):
        ref = JaxPipeline(jmodel, jparams, JaxConfig(
            **CAPS, explosion=lam,
            window=jwin.WindowConfig(kind=jwin.STREAMING)))
        ref.run_stream(s.edges, s.feats, tick_edges=64)
        model = GraphSAGE((8, 12, 12))
        model.load_state_dict(params_from_numpy(
            jax.tree.map(np.asarray, jparams)))
        pipe = D3Pipeline(model, PipelineConfig(
            **CAPS, explosion=lam,
            window=twin.WindowConfig(kind=twin.STREAMING)), device="cpu")
        pipe.run_stream(s.edges, s.feats, tick_edges=64)
        out[lam] = (ref, pipe)
    return out


@pytest.mark.parametrize("lam", [1.0, 1.5, 2.0])
def test_balance_metrics_equal_jax_after_the_same_stream(streamed, lam):
    ref, pipe = streamed[lam]
    assert pipe.cfg.base_parallelism == ref.cfg.base_parallelism == 2
    assert pipe.part.load_imbalance() == ref.part.load_imbalance()
    np.testing.assert_array_equal(pipe.metrics.busy_logical,
                                  ref.metrics.busy_logical)
    got, want = pipe.physical_busy_per_layer(), ref.physical_busy_per_layer()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if lam > 1.0:       # deeper layers spread over more sub-operators
        assert len(got[1]) > len(got[0])
    m = pipe.metrics
    assert m.emitted_total == ref.metrics.emitted_total > 0
    # the same formula over each package's own wall clock
    assert m.throughput == m.emitted_total / m.wall_seconds
    assert ref.metrics.throughput == \
        ref.metrics.emitted_total / ref.metrics.wall_seconds
    assert StreamMetrics().throughput == JaxMetrics().throughput == 0.0
    assert PipelineConfig().explosion == JaxConfig().explosion == 1.0
