"""The JAX package's public methods that the port's classes take under the
same names, each held to the JAX function on the same inputs (numpy
draws; the models' parameters are JAX's, through `repro_torch.convert`):
`PNA.loss`, `GatedGCN.loss`, `DimeNet.loss`, `NequIP.loss` (cross-entropy
over (labels, mask) at full_graph_sm, and DimeNet's and NequIP's energy
MSE at molecule), `Embedding.attend`, `Graph.replace`,
`windowing.cms_update` and `recsys.embedding_bag.embedding_bag_lookup`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import windowing as jwin
from repro.graph.graphs import Graph as JaxGraph
from repro.graph.triplets import build_triplets
from repro.nn.layers import Embedding as JaxEmbedding
from repro.recsys.embedding_bag import embedding_bag_lookup as jax_lookup
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import windowing as twin
from repro_torch.graph.graphs import Graph
from repro_torch.nn.layers import Embedding
from repro_torch.recsys.embedding_bag import embedding_bag_lookup

LOSS_RTOL = 1e-5
N, E = 48, 160


def graphs(shape, seed=0):
    """(JAX Graph, port Graph, JAX targets, port targets): an erdos graph
    with a ring edge into every node (so no node lacks an in-edge: R17),
    16 features and positions; at full_graph_sm (labels, mask) of 7
    classes, at molecule 4 graphs of 12 nodes and their energies."""
    rng = np.random.default_rng(seed)
    ring = np.arange(N)
    s = np.concatenate([rng.integers(0, N, E), ring])
    r = np.concatenate([rng.integers(0, N, E), (ring + 1) % N])
    x = rng.normal(size=(N, 16)).astype(np.float32)
    pos = (3 * rng.normal(size=(N, 3))).astype(np.float32)
    kw = {}
    if shape == "molecule":
        kw = {"graph_ids": ring // (N // 4), "n_graphs": 4}
        y = rng.normal(size=4).astype(np.float32)
        jt, pt = jnp.asarray(y), torch.tensor(y)
    else:
        lab = rng.integers(0, 7, N)
        mask = rng.random(N) < 0.8
        jt = (jnp.asarray(lab, jnp.int32), jnp.asarray(mask))
        pt = (torch.tensor(lab), torch.tensor(mask))
    jg = JaxGraph(senders=jnp.asarray(s, jnp.int32),
                  receivers=jnp.asarray(r, jnp.int32), x=jnp.asarray(x),
                  pos=jnp.asarray(pos), **{k: (jnp.asarray(v, jnp.int32)
                                                if k == "graph_ids" else v)
                                            for k, v in kw.items()})
    pg = Graph(senders=torch.tensor(s), receivers=torch.tensor(r),
               x=torch.tensor(x), pos=torch.tensor(pos),
               **{k: (torch.tensor(v) if k == "graph_ids" else v)
                  for k, v in kw.items()})
    return jg, pg, jt, pt


def models(arch, shape):
    jm = jax_get_arch(arch).build_reduced(shape)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    pm = get_arch(arch).build_reduced(shape, device="cpu")
    pm.load_state_dict(convert.graph_params_from_numpy(tree))
    return jm, jax.tree.map(jnp.asarray, tree), pm


@pytest.mark.parametrize("arch", ["pna", "gatedgcn"])
def test_node_classifier_loss_matches_jax(arch):
    jm, params, pm = models(arch, "full_graph_sm")
    jg, pg, (jl, jmask), (pl, pmask) = graphs("full_graph_sm")
    want = float(jm.loss(params, jg, jl, jmask))
    got = float(pm.loss(pg, pl, pmask))
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_dimenet_loss_matches_jax(shape):
    jm, params, pm = models("dimenet", shape)
    jg, pg, jt, pt = graphs(shape)
    trip = build_triplets(np.asarray(jg.senders), np.asarray(jg.receivers),
                          N, 1024)
    want = float(jm.loss(params, jg, jt, *(jnp.asarray(t) for t in trip)))
    got = float(pm.loss(pg, pt, *(torch.tensor(np.asarray(t))
                                  for t in trip)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_nequip_loss_matches_jax(shape):
    jm, params, pm = models("nequip", shape)
    jg, pg, jt, pt = graphs(shape)
    want = float(jm.loss(params, jg, jt))
    got = float(pm.loss(pg, pt))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_embedding_attend_matches_jax():
    emb = JaxEmbedding(50, 8)
    params = emb.init(jax.random.key(0))
    x = np.random.default_rng(0).normal(size=(3, 5, 8)).astype(np.float32)
    port = Embedding(50, 8, device="cpu")
    port.table.data.copy_(torch.tensor(np.asarray(params["table"])))
    got = port.attend(torch.tensor(x))
    assert got.shape == (3, 5, 50)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(emb.attend(params, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_graph_replace_matches_jax():
    jg, pg, _, _ = graphs("molecule")
    mask = np.arange(E + N) % 3 > 0
    jr = jg.replace(edge_mask=jnp.asarray(mask), n_graphs=2)
    pr = pg.replace(edge_mask=torch.tensor(mask), n_graphs=2)
    assert pr is not pg and pg.edge_mask is None and pg.n_graphs == 4
    assert (pr.n_graphs, pr.n_nodes, pr.n_edges) == \
        (jr.n_graphs, jr.n_nodes, jr.n_edges)
    for name in ("senders", "receivers", "x", "pos", "graph_ids",
                 "edge_mask"):
        np.testing.assert_array_equal(getattr(pr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    assert pr.node_mask is None and jr.node_mask is None


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_cms_update_matches_jax(decay):
    rng = np.random.default_rng(3)
    cms = rng.random((4, 64)).astype(np.float32)
    keys = rng.integers(0, 2 ** 31 - 1, 40)
    w = rng.random(40).astype(np.float32)
    want = jwin.cms_update(jnp.asarray(cms), jnp.asarray(keys, jnp.int32),
                           jnp.asarray(w), decay)
    got = twin.cms_update(torch.tensor(cms), torch.tensor(keys),
                          torch.tensor(w), decay)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_lookup_matches_jax(mode):
    """Padding, an all-padding bag (reads 0) and an id past the table
    (its bag reads NaN, as `jnp.take`'s fill mode gives it)."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    ids = rng.integers(-1, 30, (9, 5))
    ids[2] = -1
    ids[5, 1] = 30
    got = embedding_bag_lookup(torch.tensor(table), torch.tensor(ids), mode)
    want = np.asarray(jax_lookup(jnp.asarray(table),
                                 jnp.asarray(ids, jnp.int32), mode))
    assert np.isnan(want[5]).all() and (want[2] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
