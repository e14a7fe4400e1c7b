"""The port's locality plan and sharded full-graph train step
(repro_torch.dist.gnn_locality, StreamMesh.exchange / all_reduce_grads)
against the JAX package on the CPU.

  * `build_plan`: every array equal to JAX's, bit for bit and dtype for
    dtype, and the same AssertionError messages where JAX's asserts fire
    (nodes not divisible by the ranks, halo overflow, edge overflow);
  * the step: 4 gloo ranks (`launch/mesh.py:spawn_stream_mesh`, CPU
    tensors) each run `make_locality_train_step` on its block of
    tests/test_perf_machinery.py's graph (64 nodes, 300 uniform edges,
    PNA(8, 16, 2 layers, 4 classes, avg_log_deg 1.5), JAX's init at key
    0), with local_update False and True, against JAX's global
    single-device step: the loss within 1e-5 * max(1, |loss|) and every
    updated parameter within 1e-5 absolute (the reference's own contract
    for its locality step, test_perf_machinery.py:36-94); the gradients
    before the clip per leaf within 1e-3 of the leaf's max, PNA's f32
    gradient bound against the reference's (test_torch_graph_zoo.py,
    R17). One halo row dropped on one rank must fail that comparison on
    every rank (its loss alone moves by 3e-6 relative, inside the loss
    bound: the gradients catch it);
  * compute_dtype=bfloat16: each layer's output dtype equal to JAX's for
    the same layer on bf16 input (PNA promotes to f32 where its f32
    degree scalers meet the bf16 aggregates), and the loss within 1e-2
    relative of JAX's global loss on bf16 input.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.dist.gnn_locality import _pna_local_update as jax_local_update
from repro.dist.gnn_locality import build_plan as jax_build_plan
from repro.graph.graphs import Graph as JaxGraph
from repro.graph.pna import PNA as JaxPNA
from repro.optim import adam as jax_adam
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch import convert
from repro_torch.dist import gnn_locality
from repro_torch.dist.gnn_locality import build_plan, rank_batch
from repro_torch.graph.pna import PNA
from repro_torch.launch.mesh import spawn_stream_mesh
from repro_torch.nn.module import param_tree
from repro_torch.optim import adam

N_NODES, N_EDGES, D, N_CLS, S = 64, 300, 8, 4, 4
HIDDEN, LAYERS, AVG_LOG_DEG = 16, 2, 1.5
LOSS_TOL, PARAM_TOL, GRAD_TOL, BF16_LOSS_TOL = 1e-5, 1e-5, 1e-3, 1e-2
PLAN_FIELDS = ("senders_local", "receivers_local", "edge_mask", "send_idx",
               "send_mask")


def graph_case(seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N_NODES, N_EDGES)
    receivers = rng.integers(0, N_NODES, N_EDGES)
    x = rng.normal(size=(N_NODES, D)).astype(np.float32)
    labels = rng.integers(0, N_CLS, N_NODES).astype(np.int32)
    return senders, receivers, x, labels


# ----------------------------------------------------------------- plan
def _plan_cases():
    rng = np.random.default_rng(5)
    hub = rng.integers(0, 48, 400)
    hub[::3] = 7                                        # one hub sender
    return {
        "uniform-S4": (*graph_case()[:2], 64, 4, {}),
        "uniform-S8": (*graph_case(1)[:2], 64, 8, {}),
        "uniform-S2": (*graph_case(2)[:2], 64, 2, {}),
        "hub-S3": (hub, rng.integers(0, 48, 400), 48, 3, {}),
        "local-only": (np.arange(40) % 10, np.arange(40) % 10 + 0, 40, 4,
                       {}),
        "no-edges": (np.zeros(0, int), np.zeros(0, int), 16, 4, {}),
        "caps": (*graph_case(3)[:2], 64, 4, {"e_cap": 200, "r_cap": 40}),
    }


@pytest.mark.parametrize("name", list(_plan_cases()))
def test_build_plan_equals_jax(name):
    s, r, n, n_shards, caps = _plan_cases()[name]
    got = build_plan(s, r, n, n_shards, **caps)
    want = jax_build_plan(s, r, n, n_shards, **caps)
    assert (got.n_loc, got.r_cap) == (want.n_loc, want.r_cap)
    for f in PLAN_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("n,n_shards,caps", [
    (63, 4, {}),                         # nodes not divisible
    (64, 4, {"r_cap": 3}),               # halo overflow
    (64, 4, {"e_cap": 50}),              # edge overflow
    (64, 4, {"r_cap": 3, "e_cap": 50}),  # both: the halo check first
])
def test_build_plan_asserts_as_jax(n, n_shards, caps):
    s, r = graph_case()[:2]
    s, r = s % n, r % n
    with pytest.raises(AssertionError) as want:
        jax_build_plan(s, r, n, n_shards, **caps)
    with pytest.raises(AssertionError) as got:
        build_plan(s, r, n, n_shards, **caps)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- step
def _jax_global(params, x, compute_dtype=None):
    """JAX's global single-device step (test_perf_machinery.py's
    reference): the mean CE, its gradients, clip 1.0, Adam at 1e-3."""
    senders, receivers, _, labels = graph_case()
    model = JaxPNA(D, d_hidden=HIDDEN, n_layers=LAYERS, n_classes=N_CLS,
                   avg_log_deg=AVG_LOG_DEG)
    xj = jnp.asarray(x) if compute_dtype is None else \
        jnp.asarray(x).astype(compute_dtype)

    def loss_fn(p):
        g = JaxGraph(senders=jnp.asarray(senders, jnp.int32),
                     receivers=jnp.asarray(receivers, jnp.int32), x=xj)
        logp = jax.nn.log_softmax(model(p, g).astype(jnp.float32), -1)
        gold = jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                   -1)[:, 0]
        return -jnp.mean(gold)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    clipped, _ = jax_clip(grads, 1.0)
    upd, _ = jax_adam().update(jax_adam().init(params), clipped, params,
                               1e-3)
    return float(loss), jax.tree.map(np.asarray, grads), \
        jax.tree.map(np.asarray, jax_apply(params, upd))


def _dtype_recorder(record, real):
    def recorded(*a, **k):
        out = real(*a, **k)
        record.append(str(out.dtype).removeprefix("torch."))
        return out
    return recorded


def _locality_rank(mesh, sd, plan, x, labels):
    """Every case on this rank: {case: (loss, grads, params)} in the
    port's flat names, numpy; "bf16-*" cases also the per-layer output
    dtypes."""
    out, real = {}, gnn_locality._pna_local_update
    batch = rank_batch(plan, mesh.rank, x, labels,
                       np.ones(len(labels), bool))
    cases = {"global": (False, None), "local": (True, None),
             "bf16-global": (False, torch.bfloat16),
             "bf16-local": (True, torch.bfloat16)}
    for name, (local, dtype) in cases.items():
        model = PNA(D, HIDDEN, LAYERS, N_CLS, AVG_LOG_DEG, device="cpu")
        model.load_state_dict(sd)
        record = []
        hooks = [layer.register_forward_hook(
            lambda m, a, o: record.append(str(o.dtype).removeprefix(
                "torch."))) for layer in model.layers]
        gnn_locality._pna_local_update = _dtype_recorder(record, real)
        step = gnn_locality.make_locality_train_step(
            model, N_CLS, mesh, local_update=local, compute_dtype=dtype)
        params = param_tree(model)
        _, grads = step.grads_fn(params, batch)
        del record[:]
        new, _, loss = step(params, adam().init(params), batch)
        for h in hooks:
            h.remove()
        gnn_locality._pna_local_update = real
        out[name] = (float(loss),
                     {k: v.numpy() for k, v in grads.items()},
                     {k: v.numpy() for k, v in new.items()}, list(record))
    # a planted fault: one halo row rank 0 sends to rank 1 dropped
    if mesh.rank == 0:
        batch["send_mask"] = batch["send_mask"].clone()
        batch["send_mask"][1, 0] = False
    model = PNA(D, HIDDEN, LAYERS, N_CLS, AVG_LOG_DEG, device="cpu")
    model.load_state_dict(sd)
    step = gnn_locality.make_locality_train_step(model, N_CLS, mesh)
    params = param_tree(model)
    _, grads = step.grads_fn(params, batch)
    new, _, loss = step(params, adam().init(params), batch)
    out["dropped-halo"] = (float(loss),
                           {k: v.numpy() for k, v in grads.items()},
                           {k: v.numpy() for k, v in new.items()}, [])
    out["calls"] = dict(mesh.calls)
    return out


@pytest.fixture(scope="module")
def runs():
    senders, receivers, x, labels = graph_case()
    model = JaxPNA(D, d_hidden=HIDDEN, n_layers=LAYERS, n_classes=N_CLS,
                   avg_log_deg=AVG_LOG_DEG)
    params = model.init(jax.random.key(0))
    sd = convert.graph_params_from_numpy(jax.tree.map(np.asarray, params))
    plan = build_plan(senders, receivers, N_NODES, S)
    port = spawn_stream_mesh(S, _locality_rank, backend="gloo",
                             device="cpu", args=(sd, plan, x, labels),
                             timeout=300)
    return params, port


def _breaches(run, jax_ref):
    """What of one rank's (loss, grads, params) misses JAX's global step:
    the loss by more than LOSS_TOL * max(1, |loss|), a gradient leaf by
    more than GRAD_TOL of the leaf's max, a parameter by more than
    PARAM_TOL. [] when the run passes."""
    loss, grads, new, _ = run
    jloss, jgrads, jnew = jax_ref
    out = []
    if abs(loss - jloss) > LOSS_TOL * max(1.0, abs(jloss)):
        out.append(f"loss {loss} vs {jloss}")
    for got, want_tree, tol, absolute in ((new, jnew, PARAM_TOL, True),
                                          (grads, jgrads, GRAD_TOL, False)):
        want = convert.GraphLayout().to_port(want_tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            err = float(np.abs(got[k] - w).max())
            bound = tol if absolute else tol * float(np.abs(w).max())
            if err > bound:
                out.append(f"{k}: {err} > {bound}")
    return out


@pytest.mark.parametrize("case", ["global", "local"])
def test_locality_step_equals_jax_global_step(runs, case):
    params, port = runs
    ref = _jax_global(params, graph_case()[2])
    for rank, r in enumerate(port):
        assert _breaches(r[case], ref) == [], rank
    # each rank exchanged a halo per layer, and its cotangent back for
    # every layer but the first (x needs no gradient), and all_reduced
    # its gradients
    calls = port[0]["calls"]
    n_passes = calls["halo backward"][0] // (LAYERS - 1)
    assert n_passes > 0 and calls["halo"][0] == LAYERS * n_passes
    assert calls["grad_all_reduce"][0] == n_passes


def test_dropped_halo_row_fails_the_comparison(runs):
    params, port = runs
    ref = _jax_global(params, graph_case()[2])
    for r in port:
        assert _breaches(r["dropped-halo"], ref)


@pytest.mark.parametrize("case", ["bf16-global", "bf16-local"])
def test_bf16_compute_promotes_as_jax(runs, case):
    params, port = runs
    senders, receivers, x, _ = graph_case()
    model = JaxPNA(D, d_hidden=HIDDEN, n_layers=LAYERS, n_classes=N_CLS,
                   avg_log_deg=AVG_LOG_DEG)
    g = JaxGraph(senders=jnp.asarray(senders, jnp.int32),
                 receivers=jnp.asarray(receivers, jnp.int32),
                 x=jnp.asarray(x).astype(jnp.bfloat16))
    want, h = [], g.x
    for i, layer in enumerate(model.layers):
        if case == "bf16-local":
            h = jax_local_update(layer, params[f"l{i}"], h, g.senders,
                                 g.receivers, None, N_NODES)
        else:
            h = layer(params[f"l{i}"], g, h)
        want.append(str(h.dtype))
    jloss = _jax_global(params, x, jnp.bfloat16)[0]
    for r in port:
        loss, _, _, dtypes = r[case]
        assert dtypes == want, (dtypes, want)
        assert abs(loss - jloss) <= BF16_LOSS_TOL * abs(jloss), (loss, jloss)

