"""The port's training plane and halt-flush coordinator against the JAX
package and torch.autograd, on the CPU.

The same numpy stream, labels and JAX-initialised weights go through both
packages (tests/test_train_plane.py's sizes: 32 nodes, 4 parts, dims
(8, 16, 16), 4 classes):

  * config refusals: TrainConfig, the (train, train_cap) pair, the head,
    TrainSession and TrainingCoordinator refuse what JAX refuses, with
    ValueError / TypeError naming the same knob;
  * a quiet plane (a threshold that never fires) leaves the stream bit for
    bit the train_cap=0 program, all four policies, both drivers;
  * quiescent gradients: after the stream flushes, one label tick at lr 0
    fires exactly once and its last_grad / loss equal JAX's online plane
    and the port's own TrainingCoordinator._full_batch_grads within rtol
    1e-5 (atol 1e-7), with the live parameters bit-unchanged; both
    drivers, both delivery backends;
  * online learning: the loss falls and `steps` equals JAX's exactly,
    both drivers, with and without compression;
  * the coordinator: `_full_batch_grads` against torch.autograd of the
    static full-graph model (test_training_core.py:55, rtol 1e-4, atol
    1e-6, loss within 1e-5), the train / rebuild cycle against the static
    oracle under the updated parameters (1e-4), and the majority vote.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import windowing as jwin
from repro.core.pipeline import D3Pipeline as JaxPipeline
from repro.core.pipeline import PipelineConfig as JaxConfig
from repro.core.train_plane import TrainConfig as JaxTrainConfig
from repro.graph.sage import GraphSAGE as JaxSAGE
from repro import optim as jopt
from repro.serve import TrainSession as JaxTrainSession
from repro_torch import optim as topt
from repro_torch.convert import params_from_numpy
from repro_torch.core import windowing as twin
from repro_torch.core.oracle import build_snapshot, oracle_embeddings
from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
from repro_torch.core.train_plane import TrainConfig
from repro_torch.core.training import TrainingCoordinator
from repro_torch.graph.sage import GraphSAGE, linear_tree
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve.train_session import TrainSession

N_NODES, D, N_CLS, DIMS = 32, 8, 4, (8, 16, 16)
CAPS = dict(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=N_NODES)
POLICIES = ["streaming", "tumbling", "session", "adaptive"]


def make_stream(seed=0, n_edges=100):
    """test_train_plane.make_stream."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, N_NODES, n_edges),
                      rng.integers(0, N_NODES, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=D).astype(np.float32)
             for v in range(N_NODES)}
    labels = {v: (v * 7 + 3) % N_CLS for v in range(N_NODES)}
    return edges, feats, labels


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, JaxSAGE(DIMS, n_classes=N_CLS).init(
        jax.random.key(0)))


def port_model(jparams, n_classes=N_CLS):
    model = GraphSAGE(DIMS, n_classes=n_classes)
    tree = jparams if n_classes else {k: v for k, v in jparams.items()
                                      if k != "head"}
    model.load_state_dict(params_from_numpy(tree))
    return model


def port_pipe(jparams, train=None, train_cap=0, kind="streaming",
              backend="kernel"):
    """The model always has the head (and so the last layer's relu), as
    test_train_plane.build_pipe builds it; without train= it is unused."""
    return D3Pipeline(port_model(jparams),
                      PipelineConfig(**CAPS, train_cap=train_cap,
                                     delivery_backend=backend,
                                     window=twin.WindowConfig(kind=kind,
                                                              interval=3)),
                      train=train, device="cpu")


def jax_pipe(jparams, train=None, train_cap=0):
    model = JaxSAGE(DIMS, n_classes=N_CLS)
    params = jax.tree.map(jax.numpy.asarray, jparams)
    if train is None:
        params = {k: v for k, v in params.items() if k != "head"}
    return JaxPipeline(model, params, JaxConfig(
        **CAPS, train_cap=train_cap,
        window=jwin.WindowConfig(kind=jwin.STREAMING)), train=train)


# ------------------------------------------------------------ config plane

@pytest.mark.parametrize("kw,match", [
    (dict(optimizer="sgd"), "optimizer"),
    (dict(batch_threshold=0), "batch_threshold"),
    (dict(epochs=0), "epochs"), (dict(window=-1), "window"),
    (dict(lr=-0.1), "lr"), (dict(lr=float("nan")), "lr"),
    (dict(topk_frac=0.0), "topk_frac"), (dict(topk_frac=1.5), "topk_frac")])
def test_train_config_refusals_match_jax(kw, match):
    jkw = dict({"optimizer": jopt.sgd()}, **kw)
    tkw = dict({"optimizer": topt.sgd()}, **kw)
    with pytest.raises(ValueError, match=match):
        JaxTrainConfig(**jkw)
    with pytest.raises(ValueError, match=match):
        TrainConfig(**tkw)
    hash(TrainConfig(optimizer=topt.sgd()))


def test_pipeline_refuses_inconsistent_training(jparams):
    tcfg = TrainConfig(optimizer=topt.sgd(), batch_threshold=1)
    with pytest.raises(ValueError, match="train_cap"):
        port_pipe(jparams, train=tcfg, train_cap=0)
    with pytest.raises(ValueError, match="train_cap"):
        port_pipe(jparams, train=None, train_cap=8)
    with pytest.raises(ValueError, match="train_cap=-1"):
        PipelineConfig(train_cap=-1).validate()
    with pytest.raises(ValueError, match="head"):
        D3Pipeline(port_model(jparams, 0), PipelineConfig(**CAPS,
                                                          train_cap=8),
                   train=tcfg, device="cpu")
    # training at n_stages > 1 runs on a 2-D mesh (test_torch_stage.py);
    # without one the stages have nowhere to go, as in JAX
    with pytest.raises(ValueError, match="LocalRouter"):
        D3Pipeline(port_model(jparams), PipelineConfig(
            **CAPS, train_cap=8, n_stages=2), train=tcfg, device="cpu")
    assert PipelineConfig(**CAPS, train_cap=8).capacities().train_cap == 8
    with pytest.raises(ValueError, match="train_cap=0"):
        port_pipe(jparams).tick(labels=[(0, 1)])


def test_sessions_and_coordinator_refusals(jparams):
    with pytest.raises(ValueError, match="train_cap"):
        TrainSession(port_pipe(jparams))
    tp = port_pipe(jparams, TrainConfig(optimizer=topt.sgd(),
                                        batch_threshold=1), train_cap=8)
    with pytest.raises(ValueError, match="driver"):
        TrainSession(tp, driver="warp")
    with pytest.raises(TypeError, match="TrainConfig"):
        TrainingCoordinator(port_pipe(jparams), None, None, topt.sgd())
    with pytest.raises(ValueError, match="training plane disabled"):
        port_pipe(jparams).train_stats()


# ------------------------------------------- a quiet plane is invisible

def _drive(pipe, driver, edges, feats, labels=None, flush=True):
    if driver == "tick":
        pipe.run_stream(edges, feats, tick_edges=24)
        pipe.tick(labels=list(labels.items()) if labels else None)
        if flush:
            pipe.flush(max_ticks=128)
    else:
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        pipe.run_super_tick(T=1, label_chunks=[list(labels.items())]
                            if labels else None)
        if flush:
            pipe.flush_super(max_ticks=128, T=4)
    return pipe


@pytest.mark.parametrize("kind", POLICIES)
def test_quiet_train_plane_bit_identity(jparams, kind):
    edges, feats, labels = make_stream()
    tcfg = TrainConfig(optimizer=topt.sgd(), lr=0.1, batch_threshold=10_000)
    for driver in ("tick", "super"):
        ref = _drive(port_pipe(jparams, kind=kind), driver, edges, feats)
        got = _drive(port_pipe(jparams, tcfg, 64, kind=kind), driver, edges,
                     feats, labels)
        a, b = ref.embeddings(), got.embeddings()
        assert set(a) == set(b) and a
        for vid in a:
            np.testing.assert_array_equal(b[vid], a[vid])
        for k in ("ticks", "reduce_msgs", "broadcast_msgs",
                  "cross_part_msgs", "emitted_total", "dropped"):
            assert getattr(got.metrics, k) == getattr(ref.metrics, k), k
        st = got.train_stats()
        assert st["steps"] == 0 and st["loss"] == 0.0


# ------------------------------- quiescent grads == JAX == coordinator

@pytest.fixture(scope="module")
def jax_quiescent(jparams):
    edges, feats, labels = make_stream()
    pipe = jax_pipe(jparams, JaxTrainConfig(optimizer=jopt.sgd(), lr=0.0,
                                            batch_threshold=1), 64)
    pipe.run_stream(edges, feats, tick_edges=24)
    pipe.flush(max_ticks=128)
    pipe.tick(labels=list(labels.items()))
    return pipe.train_stats(), jax.tree.map(np.asarray,
                                            pipe.train_state.last_grad)


def _assert_tree_close(got, want, rtol=1e-5, atol=1e-7):
    ga, wa = tree_leaves(got), jax.tree.leaves(want)
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("driver,backend", [("tick", "kernel"),
                                            ("tick", "scatter"),
                                            ("super", "kernel")])
def test_quiescent_grads_match_jax_and_coordinator(jparams, jax_quiescent,
                                                   driver, backend):
    """lr 0: the label tick after the flush fires exactly once on the
    quiescent fixed point; its gradients are JAX's online ones and the
    port coordinator's full-batch ones, and the parameters do not move."""
    edges, feats, labels = make_stream()
    jst, jgrad = jax_quiescent
    tcfg = TrainConfig(optimizer=topt.sgd(), lr=0.0, batch_threshold=1)
    pipe = port_pipe(jparams, tcfg, 64, backend=backend)
    if driver == "tick":
        pipe.run_stream(edges, feats, tick_edges=24)
        pipe.flush(max_ticks=128)
        pipe.tick(labels=list(labels.items()))
    else:
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        pipe.flush_super(max_ticks=128, T=4)
        pipe.run_super_tick(T=1, label_chunks=[list(labels.items())])
    st = pipe.train_stats()
    assert st["steps"] == jst["steps"] == 1
    np.testing.assert_allclose(st["loss"], jst["loss"], rtol=1e-5)
    ts = pipe.train_state
    _assert_tree_close({k: ts.last_grad[k] for k in ("l0", "l1", "head")},
                       {k: jgrad[k] for k in ("l0", "l1", "head")})
    # the port's halt-flush coordinator on a flushed pipeline of the same
    # stream
    ref = _drive(port_pipe(jparams, backend=backend), "tick", edges, feats)
    coord = TrainingCoordinator(ref, port_model(jparams).head,
                                linear_tree(port_model(jparams).head),
                                tcfg)
    coord.observe_labels(labels)
    loss, hg, pg = coord._full_batch_grads(*coord._device_labels())
    np.testing.assert_allclose(st["loss"], float(loss), rtol=1e-5)
    _assert_tree_close(ts.last_grad["head"], hg)
    for name in ("l0", "l1"):
        _assert_tree_close(ts.last_grad[name],
                           {k: {kk: vv.sum(0) for kk, vv in v.items()}
                            for k, v in pg[name].items()})
        for a, b in zip(tree_leaves(ts.params[name]),
                        jax.tree.leaves(jparams[name])):
            np.testing.assert_array_equal(a.numpy(), b)
        for a, b in zip(tree_leaves(pipe.layers[int(name[1:])]
                                    .param_tree()),
                        jax.tree.leaves(jparams[name])):
            np.testing.assert_array_equal(a.numpy(), b)


# --------------------------------------------------- online learning

def _online(sess, pipe, edges, feats, labels, driver, passes=5):
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    sess.observe_labels(labels)
    if driver == "tick":
        for e, f in zip(e_chunks, f_chunks):
            sess.advance(e, f)
    else:
        sess.advance_super(e_chunks, f_chunks)
    sess.flush()
    first = sess.train_stats()
    for _ in range(passes):
        sess.observe_labels(labels)
        sess.flush()
    return first, sess.train_stats()


@pytest.mark.parametrize("driver,compression", [("tick", False),
                                                ("super", False),
                                                ("tick", True)])
def test_online_training_matches_jax(jparams, driver, compression):
    """The loss falls over repeated label passes and every fired step
    lands where JAX's does: equal `steps`, losses within rtol 1e-4."""
    edges, feats, labels = make_stream()
    kw = dict(lr=0.1, batch_threshold=4, compression=compression,
              topk_frac=0.5)
    pipe = port_pipe(jparams, TrainConfig(optimizer=topt.sgd(), **kw), 64)
    if compression:
        assert pipe.train_state.residual
    first, last = _online(TrainSession(pipe, driver=driver, super_ticks=4),
                          pipe, edges, feats, labels, driver)
    jp = jax_pipe(jparams, JaxTrainConfig(optimizer=jopt.sgd(), **kw), 64)
    jfirst, jlast = _online(JaxTrainSession(jp, driver=driver,
                                            super_ticks=4),
                            jp, edges, feats, labels, driver)
    assert first["steps"] > 0 and first["backlog"] == 0
    assert last["steps"] > first["steps"]
    assert last["loss"] < first["loss"]
    assert np.isfinite(last["grad_norm"])
    for a, b in ((first, jfirst), (last, jlast)):
        assert a["steps"] == b["steps"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-4)


# ------------------------------------------------------- the coordinator

def _coord_setup(seed=0, n_nodes=50, n_edges=150, d_in=8, n_cls=4):
    """test_training_core.setup, on the port."""
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n_nodes, n_edges),
                      rng.integers(0, n_nodes, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=d_in).astype(np.float32)
             for v in range(n_nodes)}
    labels = {v: int(rng.integers(0, n_cls)) for v in range(n_nodes)}
    model = GraphSAGE((d_in, 16, 16), n_classes=n_cls, seed=seed)
    body = GraphSAGE((d_in, 16, 16), seed=seed)
    body.load_state_dict({k: v for k, v in model.state_dict().items()
                          if not k.startswith("head")})
    for lb, lm in zip(body.layers, model.layers):
        lb.act = lm.act
    pipe = D3Pipeline(body, PipelineConfig(
        n_parts=4, node_cap=64, edge_cap=256, repl_cap=256, feat_cap=512,
        edge_tick_cap=64, max_nodes=n_nodes,
        window=twin.WindowConfig(kind=twin.STREAMING)), device="cpu")
    pipe.run_stream(edges, feats, tick_edges=32)
    coord = TrainingCoordinator(pipe, model.head, linear_tree(model.head),
                                TrainConfig(optimizer=topt.sgd(), lr=0.1,
                                            batch_threshold=2))
    coord.observe_labels(labels)
    return edges, feats, labels, model, pipe, coord


def test_layered_backprop_matches_autograd():
    edges, feats, labels, model, pipe, coord = _coord_setup()
    pipe.flush()
    loss, hg, pg = coord._full_batch_grads(*coord._device_labels())
    g, _ = build_snapshot(edges, feats, 8, 50, "cpu")
    y = torch.tensor([labels[v] for v in range(50)])
    ref = model.loss(g, y, torch.ones(50, dtype=torch.bool))
    grads = torch.autograd.grad(ref, list(model.parameters()))
    by_name = dict(zip([n for n, _ in model.named_parameters()], grads))
    assert abs(float(loss) - float(ref.detach())) < 1e-5
    for i in range(2):
        for tree_k, mod in (("self", "w_self"), ("neigh", "w_neigh")):
            for leaf, got in pg[f"l{i}"][tree_k].items():
                np.testing.assert_allclose(
                    got.sum(0).numpy(),
                    by_name[f"layers.{i}.{mod}.{leaf}"].numpy(),
                    rtol=1e-4, atol=1e-6)
    for leaf in ("w", "b"):
        np.testing.assert_allclose(hg[leaf].numpy(),
                                   by_name[f"head.{leaf}"].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_train_cycle_decreases_loss_and_rebuilds():
    edges, feats, labels, model, pipe, coord = _coord_setup(seed=1)
    res = coord.train(epochs=3)
    assert res.losses[-1] < res.losses[0]
    g, _ = build_snapshot(edges, feats, 8, 50, "cpu")
    body = pipe.model
    ref = oracle_embeddings(body, g).numpy()
    for vid, vec in pipe.embeddings().items():
        np.testing.assert_allclose(vec, ref[vid], rtol=1e-4, atol=1e-4)
    # streaming continues correctly after training resumes
    rng = np.random.default_rng(5)
    more = np.stack([rng.integers(0, 50, 20), rng.integers(0, 50, 20)], 1)
    more = more[more[:, 0] != more[:, 1]]
    pipe.run_stream(more, feats, tick_edges=10)
    pipe.flush(max_ticks=64)
    g2, _ = build_snapshot(np.concatenate([edges, more]), feats, 8, 50,
                           "cpu")
    ref2 = oracle_embeddings(body, g2).numpy()
    for vid, vec in pipe.embeddings().items():
        np.testing.assert_allclose(vec, ref2[vid], rtol=1e-4, atol=1e-4)


def test_majority_vote():
    *_, coord = _coord_setup(seed=2)
    assert coord.votes() >= 3 and coord.should_train()
    coord2 = TrainingCoordinator(coord.pipe, coord.head, coord.head_params,
                                 TrainConfig(optimizer=topt.sgd(),
                                             batch_threshold=10_000))
    coord2.observe_labels({0: 1})
    assert not coord2.should_train()
