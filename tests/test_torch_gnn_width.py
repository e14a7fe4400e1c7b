"""The graph zoo's train steps at the published configs against JAX on the
CPU: PNA as `build("minibatch_lg")` builds it (d_in 602, 4 layers of 75,
41 classes, minibatch_lg's avg_log_deg) on a sampled batch of 16 seeds at
fanout (15, 10), and DimeNet as `build("molecule")` builds it (6 blocks
of 128, 8 bilinear, 7 spherical, 6 radial) on 16 molecules of 30 nodes
and 64 edges. Only the batch is cut: the card runs 1,024 seeds and 128
molecules. From the same JAX init, each package takes its spec's train
step (clip_by_global_norm(1.0), then Adam at 1e-3) twice, which gives the
loss before one update and after it.

At these configs the loss RISES after that update, in JAX as in the port.
Adam's first step moves every weight by about lr whatever its gradient.
PNA's sampled batch has leaves with no in-edge, whose layer-0 outputs its
attenuation scaler multiplies by ~1e3 (R17), and four layers carry them
to the seeds. This is the witness that the rise `chip_smoke.py`'s
[gnn-train] shows on the card (PNA at minibatch_lg, DimeNet at molecule;
PERF.md) is the reference's recipe and not the port's.

Tolerances:
  * float64 parameters and batch (Adam's moments stay f32 in both): both
    losses within 1e-5 * |jax|;
  * f32: the loss before the update within 1e-5 * |jax|; after it,
    DimeNet's within 1e-5 * |jax|, PNA's within 1e-2 * |jax| of JAX's and
    of the float64 run's. Adam's first step is about lr * sign(g), and
    PNA's f32 gradient is ill-conditioned (its std aggregator cancels;
    R17), so rounding flips the sign of its smallest elements: measured,
    the port 3.5e-3 from JAX, JAX 1.3e-3 and the port 2.2e-3 from float64.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import test_torch_zoo_harness as gp
from repro.configs import get_arch as jax_get_arch
from repro.optim import adam as jax_adam
from repro_torch.configs import get_arch
from repro_torch.graph.graphs import powerlaw_edges
from repro_torch.graph.sampler import CSRGraph, sample_subgraph
from repro_torch.graph.triplets import build_triplets

LOSS_TOL = 1e-5
PNA_F32_STEP_TOL = 1e-2


def sampled_batch(seed=0, n_nodes=2000, n_edges=40_000, seeds=16,
                  d_feat=602, n_classes=41):
    """A minibatch_lg-style batch of the port's sampler (equal to JAX's,
    test_torch_graph_zoo.py::test_csr_and_sampler_equal_jax) over a
    powerlaw_edges graph at alpha 0.5, as chip_smoke's [gnn-train] draws
    it: padded to the sampler's caps, the loss on the seeds."""
    rng = np.random.default_rng(seed)
    edges = powerlaw_edges(rng, n_nodes, n_edges, 0.5)
    csr = CSRGraph.from_edges(edges[:, 0], edges[:, 1], n_nodes)
    feats = rng.standard_normal((n_nodes, d_feat), dtype=np.float32)
    sub, local_seeds, _ = sample_subgraph(
        rng, csr, rng.choice(n_nodes, seeds, replace=False), (15, 10), feats)
    n = int(sub.node_mask.sum())
    labels = np.zeros(sub.n_nodes, np.int64)
    labels[:n] = rng.integers(0, n_classes, n)
    label_mask = np.zeros(sub.n_nodes, bool)
    label_mask[local_seeds] = True
    return {"senders": sub.senders.numpy(),
            "receivers": sub.receivers.numpy(), "x": sub.x.numpy(),
            "edge_mask": sub.edge_mask.numpy(),
            "node_mask": sub.node_mask.numpy(), "labels": labels,
            "label_mask": label_mask}


def molecule_batch():
    """16 molecules of 30 nodes and 64 edges (the harness's), with their
    triplets capped at 4 x E as the reference caps them."""
    b = gp.molecule_batch(3, d_feat=16, n_graphs=16, nodes_per=30,
                          edges_per=64)
    kj, ji, tm = build_triplets(b["senders"], b["receivers"],
                                b["x"].shape[0], 4 * b["senders"].shape[0])
    b.update(t_kj=np.asarray(kj, np.int64), t_ji=np.asarray(ji, np.int64),
             t_mask=np.asarray(tm))
    return b


CASES = {"pna": ("minibatch_lg", sampled_batch),
         "dimenet": ("molecule", molecule_batch)}


def _as(batch, f64):
    return {k: v.astype(np.float64) if f64 and v.dtype == np.float32 else v
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def width_case(request):
    """Both packages' losses before and after one update, f32 and
    float64, from one JAX init: {dtype: (jax losses, port losses)}."""
    arch = request.param
    shape, make = CASES[arch]
    batch = make()
    jmodel = jax_get_arch(arch).build(shape)
    params = jmodel.init(jax.random.key(5))
    out = {}
    for f64 in (False, True):
        b = _as(batch, f64)
        with jax.enable_x64(f64):
            p = jax.tree.map(lambda a: a.astype(jnp.float64 if f64 else
                                                jnp.float32), params)
            step = jax.jit(jax_get_arch(arch).step(jmodel, shape))
            state, jax_losses = jax_adam().init(p), []
            for _ in range(2):
                p, state, loss = step(p, state, gp.jax_batch(b))
                jax_losses.append(float(loss))
        model = gp.load_jax_params(get_arch(arch).build(shape, device="cpu"),
                                   params)
        if f64:
            model = model.double()
        runs = gp.port_runs(get_arch(arch).step(model, shape), model, b)
        out["f64" if f64 else "f32"] = (jax_losses, [r[0] for r in runs])
    return dict(arch=arch, batch=batch, losses=out)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_loss_rises_after_one_update_as_in_jax(width_case, dtype):
    arch = width_case["arch"]
    (j0, j1), (p0, p1) = width_case["losses"][dtype]
    assert j1 > j0 and p1 > p0, (arch, dtype, (j0, j1), (p0, p1))
    assert abs(p0 - j0) <= LOSS_TOL * abs(j0), (arch, dtype, p0, j0)
    if arch == "pna" and dtype == "f32":
        wide = width_case["losses"]["f64"][0][1]
        for got in (p1, j1):
            assert abs(got - wide) <= PNA_F32_STEP_TOL * abs(wide), \
                (got, wide)
        assert abs(p1 - j1) <= PNA_F32_STEP_TOL * abs(j1), (p1, j1)
    else:
        assert abs(p1 - j1) <= LOSS_TOL * abs(j1), (arch, dtype, p1, j1)


def test_sampled_batch_has_leaves_without_an_in_edge():
    """The precondition of PNA's rise: the last hop's nodes receive no
    edge, and the loss sits on the seeds."""
    b = sampled_batch()
    n = int(b["node_mask"].sum())
    fed = np.zeros(len(b["node_mask"]), bool)
    fed[b["receivers"][b["edge_mask"]]] = True
    assert (~fed[:n]).sum() > n // 2
    assert fed[b["label_mask"]].all() and b["label_mask"].sum() == 16
