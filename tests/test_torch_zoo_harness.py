"""Shared harness of the graph-zoo parity tests (test_torch_graph_zoo.py,
test_torch_geometric.py; it holds no test itself): numpy-drawn batches
fed to both packages, the
JAX `init`'s parameters loaded into the port's model (`convert`), and the
comparisons with their tolerances:

  * forward: |port - jax| <= FWD_TOL * (1 + |jax|) per element;
  * gradients, and parameters and Adam's moments after each train step:
    per leaf, max |port - jax| <= LEAF_TOL * max |jax| of that leaf (f32
    sums in another order through a few layers); a leaf that is all zero
    in JAX must be within 1e-12 of zero;
  * losses within FWD_TOL * |jax|; Adam's step counter equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.graph.graphs import Graph as JaxGraph
from repro_torch import convert
from repro_torch.configs.base import value_and_grad
from repro_torch.graph.graphs import Graph
from repro_torch.nn.module import param_tree
from repro_torch.optim import adam

FWD_TOL, LEAF_TOL = 1e-5, 1e-4
INT_KEYS = ("senders", "receivers", "graph_ids", "labels", "t_kj", "t_ji")


def random_graph(seed, n_nodes=24, n_edges=80, d_feat=8, n_classes=5,
                 masked=0.2, with_pos=False, isolated=True):
    """A numpy batch: uniform edges (isolated: node n_nodes - 1 gets
    none), a share `masked` of them padding, standard-normal x, labels
    with a mask, and (with_pos) positions 3 * N(0, 1). Not isolated: a
    valid ring edge i -> i + 1 a node follows the uniform edges, so every
    node has an in-edge."""
    rng = np.random.default_rng(seed)
    b = {"senders": rng.integers(0, n_nodes, n_edges),
         "receivers": rng.integers(0, n_nodes - 1 if isolated else n_nodes,
                                   n_edges),
         "x": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
         "edge_mask": rng.random(n_edges) >= masked,
         "node_mask": np.ones(n_nodes, bool),
         "labels": rng.integers(0, n_classes, n_nodes),
         "label_mask": rng.random(n_nodes) < 0.8}
    if with_pos:
        b["pos"] = (3.0 * rng.normal(size=(n_nodes, 3))).astype(np.float32)
    if not isolated:
        ring = np.arange(n_nodes)
        b["senders"] = np.concatenate([b["senders"], ring])
        b["receivers"] = np.concatenate([b["receivers"],
                                         (ring + 1) % n_nodes])
        b["edge_mask"] = np.concatenate([b["edge_mask"],
                                         np.ones(n_nodes, bool)])
    return b


def molecule_batch(seed=3, isolated=False, d_feat=16, n_graphs=4,
                   nodes_per=10, edges_per=24):
    """A numpy molecule batch: n_graphs small graphs padded to 48 nodes and
    104 edges, graph ids for the shape's 128 graphs, targets [128]. Not
    isolated: each graph's first nodes_per edges are a ring, so every real
    node has an in-edge; isolated: all edges uniform."""
    rng = np.random.default_rng(seed)
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    n_pad, e_pad = N + 8, E + 8
    s = np.zeros(e_pad, np.int64)
    r = np.zeros(e_pad, np.int64)
    s[:E] = rng.integers(0, nodes_per, E) + offs
    r[:E] = rng.integers(0, nodes_per, E) + offs
    if not isolated:
        ring = np.tile(np.arange(edges_per) < nodes_per, n_graphs)
        local = np.tile(np.arange(edges_per), n_graphs)[ring]
        s[:E][ring] = local + offs[ring]
        r[:E][ring] = (local + 1) % nodes_per + offs[ring]
    x = np.zeros((n_pad, d_feat), np.float32)
    x[:N] = rng.normal(size=(N, d_feat))
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:N] = 2.0 * rng.normal(size=(N, 3))
    gids = np.zeros(n_pad, np.int64)
    gids[:N] = np.repeat(np.arange(n_graphs), nodes_per)
    return {"senders": s, "receivers": r, "x": x, "pos": pos,
            "edge_mask": np.arange(e_pad) < E,
            "node_mask": np.arange(n_pad) < N, "graph_ids": gids,
            "targets": rng.normal(size=128).astype(np.float32)}


def jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if k in INT_KEYS else None)
            for k, v in b.items()}


def port_batch(b, device="cpu"):
    return {k: torch.as_tensor(np.asarray(v, np.int64 if k in INT_KEYS
                                          else None)).to(device)
            for k, v in b.items()}


def jax_graph(b, n_graphs=1):
    jb = jax_batch(b)
    return JaxGraph(senders=jb["senders"], receivers=jb["receivers"],
                    x=jb["x"], edge_mask=jb.get("edge_mask"),
                    node_mask=jb.get("node_mask"), pos=jb.get("pos"),
                    graph_ids=jb.get("graph_ids"), n_graphs=n_graphs)


def port_graph(b, n_graphs=1, device="cpu"):
    pb = port_batch(b, device)
    return Graph(senders=pb["senders"], receivers=pb["receivers"],
                 x=pb["x"], edge_mask=pb.get("edge_mask"),
                 node_mask=pb.get("node_mask"), pos=pb.get("pos"),
                 graph_ids=pb.get("graph_ids"), n_graphs=n_graphs)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def load_jax_params(model, jax_params):
    """Load a JAX init pytree into the port's model (strict: the names
    must cover every parameter); returns the model."""
    model.load_state_dict(convert.graph_params_from_numpy(np_tree(
        jax_params)), strict=True)
    return model


def assert_close(got, want, what, tol=FWD_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert np.all(np.isfinite(got)), what
    assert np.all(err <= tol * (1 + np.abs(want))), \
        f"{what}: max err {err.max()}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def assert_leaves_close(got, want, what, tol=LEAF_TOL):
    """Per leaf max |got - want| <= tol * max |want| (1e-12 for a zero
    leaf); got and want nested dicts of arrays in JAX's layout."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys()))
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        assert np.all(np.isfinite(g[k])), (what, k)
        if not w[k].size:
            continue
        scale = np.abs(w[k]).max()
        err = np.abs(g[k] - w[k]).max()
        assert err <= max(tol * scale, 1e-12), \
            f"{what} {k}: max err {err} > {tol} x {scale}"


def port_grads(model, loss_fn, *args):
    """(loss, grads in JAX's layout, numpy) of loss_fn(*args) over the
    model's parameters."""
    loss, g = value_and_grad(model, loss_fn, param_tree(model), *args)
    return float(loss), convert.params_to_numpy(g, convert.GraphLayout())


def jax_reference(loss_of, step, params, batches, steps_on, n=2):
    """The reference's loss and gradients (loss_of(params, batch)) on each
    numpy batch, and n train steps from a fresh Adam state on
    batches[steps_on], in one jit: ({kind: (loss, grads)}, [(loss, params,
    opt_state)] after each step), numpy."""
    from repro.optim import adam as jax_adam

    def reference(p0):
        ref = {k: jax.value_and_grad(lambda p: loss_of(p, b))(p0)
               for k, b in batches.items()}
        state, runs, p = jax_adam().init(p0), [], p0
        for _ in range(n):
            p, state, loss = step(p, state, jax_batch(batches[steps_on]))
            runs.append((loss, p, state))
        return ref, runs

    ref, runs = jax.jit(reference)(params)
    return ({k: (float(l), np_tree(g)) for k, (l, g) in ref.items()},
            [(float(l), np_tree(p), np_tree(st)) for l, p, st in runs])


def port_runs(step, model, batch, n=2, device="cpu"):
    """The same for the port's train step over the model's parameters."""
    params = param_tree(model)
    state = adam().init(params)
    pb = port_batch(batch, device)
    layout = convert.GraphLayout()
    runs = []
    for _ in range(n):
        params, state, loss = step(params, state, pb)
        runs.append((float(loss), convert.params_to_numpy(params, layout),
                     convert.opt_state_to_numpy(state, layout)))
    return runs


def assert_runs_close(got, want, what):
    assert len(got) == len(want)
    for i, ((lg, pg, sg), (lw, pw, sw)) in enumerate(zip(got, want)):
        assert abs(lg - lw) <= FWD_TOL * abs(lw), (what, i, lg, lw)
        assert_leaves_close(pg, pw, f"{what} step {i} params")
        for mv in ("m", "v"):
            assert_leaves_close(sg[mv], sw[mv], f"{what} step {i} adam {mv}")
        assert int(sg["t"]) == int(sw["t"]) == i + 1
