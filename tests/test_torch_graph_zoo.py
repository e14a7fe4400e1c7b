"""The graph zoo in the port (repro_torch.graph: segment ops, GCNLayer,
MPLayer, GAT, PNA, GatedGCN, the sampler and the triplets;
configs.gnn_common and the pna / gatedgcn steps; convert.GraphLayout;
kernels.segment_reduce's gather_segment_sum and rmi_apply_read; the
launchers) against the JAX package on the CPU. Inputs are drawn with
numpy and fed to both; parameters come from the JAX `init`s, converted.

Tolerances (f32):
  * forward outputs and segment ops: |port - jax| <= 1e-5 * (1 + |jax|)
    per element (ROADMAP's contract), their gradients too;
  * model gradients, and parameters and Adam's moments after each of two
    train steps: per leaf, max |port - jax| <= 1e-4 * max |jax| of that
    leaf (f32 sums in another order through a few layers); losses within
    1e-5 * |jax|; Adam's step counter equal;
  * the sampler and the triplets: arrays equal;
  * gather_segment_sum and rmi_apply_read (plain versions) against the
    Pallas ops in interpret mode: within 1e-5 * (1 + |jax|).
PNA's gradients and train steps are compared in float64, under the same
bounds (F64: its std aggregator cancels in f32); its f32 gradients are
also held to JAX's f32 ones, per leaf within 1e-3 * max |jax| (the
measured f32 gap, 3.7e-4, with a margin). The JAX side is jitted once
per model, in module-scoped fixtures.
"""
import sys
from dataclasses import dataclass, replace
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_zoo_harness as gp
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.configs.gnn_common import make_gnn_train_step as jax_gnn_step
from repro.graph import segment as jseg
from repro.graph import mp as jax_mp
from repro.graph.gat import GAT as JaxGAT
from repro.graph.gatedgcn import GatedGCN as JaxGatedGCN
from repro.graph.graphs import powerlaw_edges as jax_powerlaw_edges
from repro.graph.sage import GCNLayer as JaxGCNLayer
from repro.graph.sampler import CSRGraph as JaxCSR
from repro.graph.sampler import sample_subgraph as jax_sample
from repro.graph.triplets import build_triplets as jax_triplets
from repro.graph.triplets import triplet_count as jax_triplet_count
from repro.kernels.segment_reduce import ops as jax_sr
from repro.kernels.segment_reduce import ref as jax_sr_ref
from repro.launch import train as jax_train
from repro.nn.layers import Linear as JaxLinear
from repro.nn.module import Module as JaxModule
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.gnn_common import GNN_SHAPES, make_gnn_train_step
from repro_torch.graph import mp, segment
from repro_torch.graph.gat import GAT
from repro_torch.graph.gatedgcn import GatedGCN
from repro_torch.graph.graphs import powerlaw_edges
from repro_torch.graph.sage import GCN
from repro_torch.graph.sampler import CSRGraph, sample_capacities, \
    sample_subgraph
from repro_torch.graph.triplets import build_triplets, triplet_count
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.nn.layers import Linear

GNN_ARCHS = ("pna", "gatedgcn", "dimenet", "nequip")


# ------------------------------------------------------------ segment ops
def _seg_case(kind, seed=0, E=60, N=10, d=3):
    """(data [E, d], ids [E], mask [E] or None): segment N - 1 gets no
    edge; `ties` puts equal values (relu zeros, repeats) in each segment."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N - 1, E)
    data = rng.normal(size=(E, d)).astype(np.float32)
    mask = rng.random(E) >= 0.3
    if kind == "ties":
        data = np.maximum(np.round(2 * data) / 2, 0).astype(np.float32)
    elif kind == "all_masked":
        mask = np.zeros(E, bool)
    elif kind == "no_mask":
        mask = None
    return data, ids, mask


SEG_OPS = ("segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_std", "segment_softmax")


@pytest.mark.parametrize("kind", ["masked", "ties", "all_masked", "no_mask"])
@pytest.mark.parametrize("op", SEG_OPS)
def test_segment_ops_and_grads_match_jax(op, kind):
    N = 10
    data, ids, mask = _seg_case(kind, N=N)
    w = np.random.default_rng(1).normal(size=(
        data.shape if op == "segment_softmax" else (N, data.shape[1])))
    jf, pf = getattr(jseg, op), getattr(segment, op)
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.as_tensor(mask)
    jids, pids = jnp.asarray(ids, jnp.int32), torch.as_tensor(ids)

    def jloss(x):
        return jnp.sum(jf(x, jids, N, jm) * w)

    want = jf(jnp.asarray(data), jids, N, jm)
    want_g = jax.grad(jloss)(jnp.asarray(data))
    x = torch.as_tensor(data).requires_grad_()
    got = pf(x, pids, N, pm)
    (got_g,) = torch.autograd.grad((got * torch.as_tensor(w)).sum(), x)
    gp.assert_close(got.detach(), want, f"{op} {kind}")
    gp.assert_close(got_g, want_g, f"{op} {kind} grad")
    if op != "segment_softmax":
        # the segment with no valid edge reads 0 (std: sqrt(eps))
        empty = 1e-5 ** 0.5 if op == "segment_std" else 0.0
        np.testing.assert_allclose(got[N - 1].detach().numpy(), empty,
                                   rtol=1e-6)


def test_segment_max_splits_the_gradient_at_ties():
    x = torch.tensor([1.0, 1.0, 0.5, 2.0], requires_grad=True)
    ids = torch.tensor([0, 0, 0, 1])
    (g,) = torch.autograd.grad(segment.segment_max(x, ids, 3).sum(), x)
    jg = jax.grad(lambda v: jseg.segment_max(
        v, jnp.asarray([0, 0, 0, 1]), 3).sum())(jnp.asarray([1.0, 1.0, 0.5,
                                                             2.0]))
    assert g.tolist() == [0.5, 0.5, 0.0, 1.0] == np.asarray(jg).tolist()


def test_segment_count_matches_jax():
    data, ids, mask = _seg_case("masked")
    got = segment.segment_count(torch.as_tensor(ids), 10,
                                torch.as_tensor(mask))
    want = jseg.segment_count(jnp.asarray(ids), 10, jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- models and steps
@dataclass(frozen=True)
class JaxGCN(JaxModule):
    """GCN layers with a head, composed as the reference's GAT composes
    its layers (the reference has the layer only)."""
    dims: tuple
    n_classes: int = 0

    def __post_init__(self):
        n = len(self.dims) - 1
        object.__setattr__(self, "layers", tuple(
            JaxGCNLayer(self.dims[i], self.dims[i + 1],
                        act=i < n - 1 or self.n_classes > 0)
            for i in range(n)))
        object.__setattr__(self, "head", JaxLinear(self.dims[-1],
                                                   self.n_classes))

    def init(self, key):
        keys = jax.random.split(key, len(self.layers) + 1)
        p = {f"l{i}": l.init(keys[i]) for i, l in enumerate(self.layers)}
        p["head"] = self.head.init(keys[-1])
        return p

    def __call__(self, params, g, x=None):
        x = g.x if x is None else x
        for i, l in enumerate(self.layers):
            x = l(params[f"l{i}"], g, x)
        return self.head(params["head"], x)


@dataclass(frozen=True)
class JaxPhi(JaxModule):
    d_in: int
    d_out: int

    def init(self, key):
        return {"lin": JaxLinear(2 * self.d_in, self.d_out).init(key)}

    def __call__(self, params, xu, xv, xe):
        return jax.nn.relu(JaxLinear(2 * self.d_in, self.d_out)(
            params["lin"], jnp.concatenate([xu, xv], -1)))


@dataclass(frozen=True)
class JaxPsi(JaxModule):
    d_in: int
    d_out: int

    def init(self, key):
        return {"lin": JaxLinear(2 * self.d_in, self.d_out).init(key)}

    def __call__(self, params, x, agg):
        return JaxLinear(2 * self.d_in, self.d_out)(
            params["lin"], jnp.concatenate([x, agg], -1))


@dataclass(frozen=True)
class JaxMPModel(JaxModule):
    d_in: int
    n_classes: int
    rho: str

    def init(self, key):
        return {"mp": jax_mp.MPLayer(JaxPhi(self.d_in, self.d_in),
                                     JaxPsi(self.d_in, self.n_classes),
                                     self.rho).init(key)}

    def __call__(self, params, g):
        return jax_mp.MPLayer(JaxPhi(self.d_in, self.d_in),
                              JaxPsi(self.d_in, self.n_classes),
                              self.rho)(params["mp"], g, g.x)


class Phi(torch.nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin = Linear(2 * d_in, d_out)

    def forward(self, xu, xv, xe):
        return torch.relu(self.lin(torch.cat([xu, xv], -1)))


class Psi(torch.nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin = Linear(2 * d_in, d_out)

    def forward(self, x, agg):
        return self.lin(torch.cat([x, agg], -1))


class MPModel(torch.nn.Module):
    def __init__(self, d_in, n_classes, rho):
        super().__init__()
        self.mp = mp.MPLayer(Phi(d_in, d_in), Psi(d_in, n_classes), rho)

    def forward(self, g):
        return self.mp(g, g.x)


D_FEAT, N_CLASSES = 16, 7          # the reduced configs at full_graph_sm


def _models(name):
    """(jax model, port model on the CPU, shape name) of a test case."""
    if name in ("pna", "gatedgcn"):
        return (jax_get_arch(name).build_reduced("full_graph_sm"),
                get_arch(name).build_reduced("full_graph_sm", device="cpu"),
                "full_graph_sm")
    if name.endswith("-molecule"):
        arch = name.split("-")[0]
        return (jax_get_arch(arch).build_reduced("molecule"),
                get_arch(arch).build_reduced("molecule", device="cpu"),
                "molecule")
    if name == "gcn":
        return (JaxGCN((D_FEAT, 16, 16), N_CLASSES),
                GCN((D_FEAT, 16, 16), N_CLASSES, device="cpu"),
                "full_graph_sm")
    if name == "gat":
        return (JaxGAT((D_FEAT, 16, 16), n_heads=4, n_classes=N_CLASSES),
                GAT((D_FEAT, 16, 16), n_heads=4, n_classes=N_CLASSES,
                    device="cpu"), "full_graph_sm")
    rho = name.split("-")[1]
    return (JaxMPModel(D_FEAT, N_CLASSES, rho),
            MPModel(D_FEAT, N_CLASSES, rho), "full_graph_sm")


def _jax_step(name, model, shape_name):
    if name.endswith("-molecule") or name in ("pna", "gatedgcn"):
        return jax_get_arch(name.split("-")[0]).step(model, shape_name)
    sh = JaxShapeSpec(shape_name, "train",
                      dict(GNN_SHAPES[shape_name].dims))
    return jax_gnn_step(model, sh, needs_pos=False, needs_triplets=False)


def _port_step(name, model, shape_name):
    if name.endswith("-molecule") or name in ("pna", "gatedgcn"):
        return get_arch(name.split("-")[0]).step(model, shape_name)
    return make_gnn_train_step(model, GNN_SHAPES[shape_name],
                               needs_triplets=False)


MODELS = ("gcn", "gat", "pna", "gatedgcn", "mp-mean", "mp-max",
          "pna-molecule", "gatedgcn-molecule")


# PNA's gradients and train steps are compared in float64 (its forward in
# f32, as every model's): its std aggregator, sqrt(Σm²/n - (Σm/n)² + eps),
# cancels in f32 wherever a segment's messages vary little against their
# mean, and its gradient there is 1/(2 sqrt(eps)) ~ 158 times that
# rounding; at an isolated node the attenuation (R17) scales features
# ~1e3. The reference's own f32 gradient lies up to 3.7e-4 of a leaf's
# max from a float64 run (measured on these batches: 8.2e-5 and 3.7e-4 at
# full_graph_sm, 2.1e-5 and 3.5e-4 at molecule; the port's 2.4e-5 to
# 1.3e-4), so f32 against f32 at the leaf bound could not tell a fault
# from rounding. In float64 the same code is held to the same bounds;
# the f32 gradients are held to JAX's f32 ones at PNA_F32_GRAD_TOL (the
# measured gap between them, 3.7e-4 at most, times ~2.7). Adam's state
# stays f32 in both (their `_f32`).
F64 = ("pna", "pna-molecule")
PNA_F32_GRAD_TOL = 1e-3


def _as(batch, f64):
    return {k: v.astype(np.float64) if f64 and v.dtype == np.float32 else v
            for k, v in batch.items()}


def _case_batches(name):
    """`connected` (every node has an in-edge) and `isolated` (not)."""
    if name.endswith("-molecule"):
        return {"connected": gp.molecule_batch(3, d_feat=D_FEAT),
                "isolated": gp.molecule_batch(4, isolated=True,
                                              d_feat=D_FEAT)}
    return {"connected": gp.random_graph(7, d_feat=D_FEAT,
                                         n_classes=N_CLASSES, isolated=False),
            "isolated": gp.random_graph(8, d_feat=D_FEAT,
                                        n_classes=N_CLASSES)}


@pytest.fixture(scope="module", params=MODELS)
def zoo_case(request):
    """One model's parameters (JAX init, loaded into the port's model),
    JAX's forward (f32), loss and gradients on two numpy batches
    (`connected`: every node has an in-edge; `isolated`: not), and JAX's
    two train steps on the connected batch; the last two in float64 for
    the models of F64."""
    name = request.param
    jmodel, pmodel, shape_name = _models(name)
    f64 = name in F64
    batches = _case_batches(name)
    params = jmodel.init(jax.random.key(11))
    gp.load_jax_params(pmodel, params)
    n_graphs = GNN_SHAPES[shape_name].dims["n_graphs"]
    with jax.enable_x64(f64):
        wide = jax.tree.map(lambda a: a.astype(jnp.float64 if f64 else
                                               jnp.float32), params)
        ref, runs = gp.jax_reference(
            lambda p, b: _jax_loss(name, jmodel, p, b, shape_name),
            _jax_step(name, jmodel, shape_name), wide,
            {k: _as(b, f64) for k, b in batches.items()}, "connected")
    fwd = {kind: np.asarray(jmodel(params, gp.jax_graph(b, n_graphs)))
           for kind, b in batches.items()}
    return dict(name=name, batches=batches, pmodel=pmodel, shape=shape_name,
                n_graphs=n_graphs, fwd=fwd, ref=ref, runs=runs, f64=f64)


def _wide_model(c):
    """A fresh port model holding the case's parameters, in float64 for
    the models of F64."""
    model = _models(c["name"])[1]
    model.load_state_dict(c["pmodel"].state_dict())
    return model.double() if c["f64"] else model


def _jax_loss(name, model, params, batch, shape_name):
    """The reference's train-step loss of the case, restated for
    jax.value_and_grad (the steps keep theirs inside)."""
    dims = GNN_SHAPES[shape_name].dims
    g = gp.jax_graph(batch, dims["n_graphs"])
    if dims["n_classes"]:
        logp = jax.nn.log_softmax(model(params, g), axis=-1)
        gold = jnp.take_along_axis(logp, jnp.asarray(batch["labels"])[:, None],
                                   axis=-1)[:, 0]
        m = jnp.asarray(batch["label_mask"] & batch["node_mask"])
        return jnp.sum(jnp.where(m, -gold, 0.0)) / jnp.maximum(jnp.sum(m), 1)
    e_node = jnp.where(g.node_mask, model(params, g)[..., 0], 0.0)
    e = jax.ops.segment_sum(e_node, g.graph_ids, g.n_graphs)
    return jnp.mean(jnp.square(e - jnp.asarray(batch["targets"])))


@pytest.mark.parametrize("kind", ["connected", "isolated"])
def test_zoo_forward_matches_jax(zoo_case, kind):
    c = zoo_case
    out = c["pmodel"](gp.port_graph(c["batches"][kind], c["n_graphs"]))
    gp.assert_close(out.detach(), c["fwd"][kind],
                    f"{c['name']} forward ({kind})")


@pytest.mark.parametrize("kind", ["connected", "isolated"])
def test_zoo_loss_and_grads_match_jax(zoo_case, kind):
    c = zoo_case
    want_loss, want_grads = c["ref"][kind]
    model = _wide_model(c)
    step = _port_step(c["name"], model, c["shape"])
    loss, grads = gp.port_grads(model, step.loss_fn, gp.port_batch(
        _as(c["batches"][kind], c["f64"])))
    assert abs(loss - want_loss) <= gp.FWD_TOL * abs(want_loss)
    gp.assert_leaves_close(grads, want_grads, f"{c['name']} grads ({kind})")


def test_zoo_train_steps_match_jax(zoo_case):
    c = zoo_case
    model = _wide_model(c)
    runs = gp.port_runs(_port_step(c["name"], model, c["shape"]), model,
                        _as(c["batches"]["connected"], c["f64"]))
    gp.assert_runs_close(runs, c["runs"], c["name"])


@pytest.fixture(scope="module", params=F64)
def pna_f32_case(request):
    """PNA's parameters (JAX init, loaded into the port's model) and JAX's
    f32 loss and gradients on the zoo cases' two batches."""
    name = request.param
    jmodel, pmodel, shape_name = _models(name)
    params = jmodel.init(jax.random.key(11))
    gp.load_jax_params(pmodel, params)
    batches = _case_batches(name)
    ref = {}
    for kind, b in batches.items():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b=b: _jax_loss(name, jmodel, p, b, shape_name)))(params)
        ref[kind] = (float(loss), gp.np_tree(grads))
    return dict(name=name, pmodel=pmodel, shape=shape_name,
                batches=batches, ref=ref)


@pytest.mark.parametrize("kind", ["connected", "isolated"])
def test_pna_f32_grads_match_jax_f32(pna_f32_case, kind):
    """The f32 path chip_smoke's [gnn-train] runs, beside the float64
    comparison: per leaf within PNA_F32_GRAD_TOL of JAX's f32 leaf max."""
    c = pna_f32_case
    want_loss, want_grads = c["ref"][kind]
    step = _port_step(c["name"], c["pmodel"], c["shape"])
    loss, grads = gp.port_grads(c["pmodel"], step.loss_fn,
                                gp.port_batch(c["batches"][kind]))
    assert abs(loss - want_loss) <= gp.FWD_TOL * abs(want_loss)
    gp.assert_leaves_close(grads, want_grads, f"{c['name']} f32 grads "
                           f"({kind})", tol=PNA_F32_GRAD_TOL)


def test_reference_pna_attenuates_an_isolated_node_by_1e6():
    """R17: the reference's PNA attenuation scaler is avg_log_deg /
    max(log(deg + 1), 1e-6), 1e6 x avg_log_deg at a node with no valid
    in-edge, and its std aggregator reads sqrt(eps) there, so the node's
    layer-0 output is ~1e3 x a connected node's. The port computes the
    same (held, not repaired: parity)."""
    jm, pm, _ = _models("pna")
    params = jm.init(jax.random.key(11))
    gp.load_jax_params(pm, params)
    b = gp.random_graph(8, d_feat=D_FEAT, n_classes=N_CLASSES)
    want = np.asarray(jm.layers[0](params["l0"], gp.jax_graph(b),
                                   jnp.asarray(b["x"])))
    g = gp.port_graph(b)
    got = pm.layers[0](g, g.x).detach().numpy()
    gp.assert_close(got, want, "PNA layer 0")
    scale = np.abs(want).max(axis=1)
    assert scale[-1] > 300 * np.median(scale[:-1])


def test_reference_serve_cli_sends_a_gnn_arch_to_its_lm_path(monkeypatch):
    """R16: the reference's serve CLI sends every arch but d3gnn-sage into
    serve_lm, which asks a GNN model for a decode cache. The port's
    refuses the arch (test_serve_cli_refuses_a_gnn_arch)."""
    from repro.launch import serve as jax_serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "pna"])
    with pytest.raises(AttributeError, match="init_cache"):
        jax_serve.main()


def test_mp_layer_refuses_an_unknown_aggregator():
    with pytest.raises(ValueError, match="rho"):
        mp.MPLayer(Phi(2, 2), Psi(2, 2), "median")


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "molecule"])
def test_published_build_has_jax_params_names_and_shapes(arch, shape):
    """build(shape) at the published widths: the same parameter names
    (through GraphLayout) and shapes as the reference's init."""
    jshapes = jax.eval_shape(jax_get_arch(arch).build(shape).init,
                             jax.random.key(0))
    want = {k: tuple(v.shape) for k, v in
            convert.GraphLayout().to_port(jshapes).items()}
    model = get_arch(arch).build(shape, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert arch in ARCH_IDS and get_arch(arch).family == "gnn"


def test_graph_layout_round_trips_a_zoo_tree():
    tree = gp.np_tree(jax_get_arch("dimenet").build_reduced().init(
        jax.random.key(0)))
    layout = convert.GraphLayout()
    flat = layout.to_port(tree)
    assert "blocks.1.mlp_out.layers.1.w" in flat
    back = layout.to_jax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


# ------------------------------------------------- sampler and triplets
def test_csr_and_sampler_equal_jax():
    edges = powerlaw_edges(np.random.default_rng(2), 300, 4000)
    np.testing.assert_array_equal(
        edges, jax_powerlaw_edges(np.random.default_rng(2), 300, 4000))
    feats = np.random.default_rng(3).normal(size=(300, 5)).astype(np.float32)
    csr = CSRGraph.from_edges(edges[:, 0], edges[:, 1], 300)
    jcsr = JaxCSR.from_edges(edges[:, 0], edges[:, 1], 300)
    np.testing.assert_array_equal(csr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(csr.indices, jcsr.indices)
    seeds = np.random.default_rng(4).choice(300, 24, replace=False)
    for fanout in ((5, 3), (15, 10), (2,)):
        g, lseeds, gids = sample_subgraph(np.random.default_rng(5), csr,
                                          seeds, fanout, feats)
        jg, jlseeds, jgids = jax_sample(np.random.default_rng(5), jcsr,
                                        seeds, fanout, feats)
        assert (g.n_nodes, g.n_edges) == sample_capacities(24, fanout)
        for f in ("senders", "receivers", "x", "edge_mask", "node_mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f)), f)
        np.testing.assert_array_equal(lseeds, jlseeds)
        np.testing.assert_array_equal(gids, jgids)
    g, _, _ = sample_subgraph(np.random.default_rng(5), csr, seeds, (3,))
    assert g.x.shape == (24 * 4, 1) and float(g.x.abs().max()) == 0.0


@pytest.mark.parametrize("seed,n,E,t_max", [
    (0, 12, 40, 160), (1, 30, 200, 50), (2, 5, 60, 7), (3, 8, 0, 16),
    (4, 40, 300, 4 * 300)])
def test_triplets_equal_jax(seed, n, E, t_max):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, E).astype(np.int32)
    r = rng.integers(0, n, E).astype(np.int32)
    got, want = build_triplets(s, r, n, t_max), jax_triplets(s, r, n, t_max)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert triplet_count(s, r, n) == jax_triplet_count(s, r, n)


def test_triplets_stop_at_the_cap_without_forming_a_hubs_pairs():
    # every edge into one hub: E^2 candidate pairs, a cap of 64
    E = 4000
    s = np.arange(1, E + 1) % 50 + 1
    r = np.zeros(E, np.int64)
    s[::2] = 0                      # half the edges leave the hub too
    kj, ji, mask = build_triplets(s, r, 51, 64)
    jkj, jji, jmask = jax_triplets(s, r, 51, 64)
    np.testing.assert_array_equal(kj, jkj)
    np.testing.assert_array_equal(ji, jji)
    assert mask.all() and jmask.all()


# --------------------------------------- kernel 1 and 2's new entries
@pytest.mark.parametrize("N,E,d,case", [
    (100, 400, 16, "masked"), (257, 1000, 32, "masked"),
    (64, 300, 8, "hub"), (64, 300, 8, "all_masked"), (64, 0, 8, "none")])
def test_gather_segment_sum_plain_matches_jax(N, E, d, case):
    rng = np.random.default_rng(N + E)
    x = rng.normal(size=(N, d)).astype(np.float32)
    s = rng.integers(0, N, E)
    r = np.full(E, 3) if case == "hub" else rng.integers(0, N, E)
    mask = rng.random(E) > 0.3
    if case == "all_masked":
        mask[:] = False
    got = sr_ops.gather_segment_sum(torch.as_tensor(x), torch.as_tensor(s),
                                    torch.as_tensor(r), N,
                                    torch.as_tensor(mask))
    args = (jnp.asarray(x), jnp.asarray(s, jnp.int32),
            jnp.asarray(r, jnp.int32), N, jnp.asarray(mask))
    gp.assert_close(got, jax_sr_ref.gather_segment_sum_ref(*args),
                    "vs the reference's plain version")
    if E:
        want = jax_sr.gather_segment_sum(*args, block_e=64, block_v=64,
                                         interpret=True)
        gp.assert_close(got, want, "vs the Pallas op (interpret)")


def test_rmi_apply_read_plain_matches_jax():
    rng = np.random.default_rng(3)
    R, C, K, d = 70, 50, 12, 6
    agg = rng.normal(size=(R, d)).astype(np.float32)
    cnt = rng.integers(-1, 4, R).astype(np.float32)
    idx = rng.integers(0, R + 6, C)
    vec = rng.normal(size=(C, d)).astype(np.float32)
    dcnt = rng.integers(0, 2, C).astype(np.float32)
    ridx = rng.integers(0, R, K)
    got = sr_ops.rmi_apply_read(*map(torch.as_tensor, (agg, cnt, idx, vec,
                                                       dcnt, ridx)))
    jargs = (jnp.asarray(agg), jnp.asarray(cnt), jnp.asarray(idx, jnp.int32),
             jnp.asarray(vec), jnp.asarray(dcnt), jnp.asarray(ridx, jnp.int32))
    want = jax_sr.rmi_apply_read(*jargs, block_e=64, block_v=64, block_r=64,
                                 interpret=True)
    for what, a, b in zip(("agg", "cnt", "dirty", "reads"), got, want):
        if what == "dirty":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            gp.assert_close(a, b, what)


# ------------------------------------------------------------- launchers
@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "molecule"])
def test_train_cli_reduced_gnn_cpu_gives_finite_losses(arch, shape, capsys):
    _, params, _, losses = train_cli.main(
        ["--arch", arch, "--shape", shape, "--reduced", "--steps", "2",
         "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert lines[-1] == "train driver done"
    assert [ln.split(":")[0] for ln in lines[:2]] == ["step 0", "step 1"]
    assert all(bool(torch.isfinite(p).all()) for p in params.values())


def test_synth_batch_draws_ids_within_their_ranges():
    spec = get_arch("dimenet")
    model = spec.build_reduced("molecule", device="cpu")
    b = train_cli.synth_batch(spec, model, "molecule", True,
                              np.random.default_rng(0), "cpu")
    N, E = b["x"].shape[0], b["senders"].shape[0]
    assert b["x"].shape[1] == model.d_in and b["targets"].shape == (128,)
    assert int(b["senders"].max()) < N and int(b["t_kj"].max()) < E
    assert int(b["graph_ids"].max()) < 100
    spec = get_arch("pna")
    b = train_cli.synth_batch(spec, spec.build("full_graph_sm",
                                               device="cpu"),
                              "full_graph_sm", False,
                              np.random.default_rng(0), "cpu")
    assert int(b["labels"].max()) < 7 and int(b["senders"].max()) >= 7


def _jax_cli(argv, monkeypatch, capsys, build=None):
    """Run the reference's launcher in process; `build` replaces its
    spec's build (a smaller model at the same shape), whose step is then
    jitted (the reference's runs op by op)."""
    if build is not None:
        ref_step = jax_get_arch(argv[1]).step
        spec = replace(jax_get_arch(argv[1]), build=build,
                       step=lambda m, s: jax.jit(ref_step(m, s)))
        monkeypatch.setattr(jax_train, "get_arch", lambda a: spec)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train.main()
    return capsys.readouterr().out


def test_reference_gnn_losses_are_nan_from_labels_past_the_classes(
        monkeypatch, capsys):
    """R14: the reference's synth_batch draws labels on [0, 100) for 7
    classes; take_along_axis reads NaN past the last class, so every loss
    is NaN. A one-layer GatedGCN at full_graph_sm's widths shows it; the
    port's launcher on the same shape and model gives finite losses."""
    small = lambda s: JaxGatedGCN(d_in=1433, d_hidden=8, n_layers=1,
                                  n_classes=7)
    out = _jax_cli(["--arch", "gatedgcn", "--shape", "full_graph_sm",
                    "--steps", "1"], monkeypatch, capsys, build=small)
    assert "step 0: loss=nan" in out
    small_port = replace(get_arch("gatedgcn"), build=lambda s, device=None,
                         seed=0, train=False: GatedGCN(
                             d_in=1433, d_hidden=8, n_layers=1, n_classes=7,
                             device=device))
    with mock.patch("repro_torch.configs.get_arch", lambda a: small_port):
        _, _, _, losses = train_cli.main(
            ["--arch", "gatedgcn", "--shape", "full_graph_sm", "--steps",
             "1", "--device", "cpu"])
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch,shape,match", [
    ("pna", "full_graph_sm", "dot_general"),
    ("dimenet", "molecule", "incompatible shapes")])
def test_reference_reduced_gnn_batch_does_not_fit_its_model(
        arch, shape, match, monkeypatch, capsys):
    """R15: the reference's --reduced batch keeps the full shape's widths:
    x at d_feat 1,433 against d_in 16 (full_graph_sm), and 2 target rows
    against the step's 128 graphs (molecule). Both raise TypeError; the
    port's launcher runs both (test_train_cli_reduced_gnn_cpu_...)."""
    with pytest.raises(TypeError, match=match):
        _jax_cli(["--arch", arch, "--shape", shape, "--reduced", "--steps",
                  "1"], monkeypatch, capsys)


def test_serve_cli_refuses_a_gnn_arch():
    with pytest.raises(ValueError, match="train shapes"):
        serve_cli.main(["--arch", "pna", "--device", "cpu"])
