"""The geometric half of the graph zoo in the port (repro_torch.graph.so3,
nequip, dimenet; configs.nequip / configs.dimenet) against the JAX
package on the CPU, on numpy-drawn molecule batches with positions;
parameters come from the JAX `init`s, converted.

Tolerances (f32):
  * the Clebsch-Gordan, real-basis and coupling tensors: equal (the same
    float64 numpy code);
  * real spherical harmonics, the Bessel and angular bases and their
    gradients, the models' forward: |port - jax| <= 1e-5 * (1 + |jax|)
    per element (ROADMAP's contract);
  * the models' gradients, and parameters and Adam's moments after each
    of two train steps: per leaf, max |port - jax| <= 1e-4 * max |jax| of
    that leaf; losses within 1e-5 * |jax|; Adam's step counter equal.
The JAX side is jitted once per model, in module-scoped fixtures.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_zoo_harness as gp
from repro.configs import get_arch as jax_get_arch
from repro.graph import so3 as jso3
from repro.graph.dimenet import angular_basis as jax_angular_basis
from repro.graph.nequip import allowed_paths as jax_allowed_paths
from repro.graph.nequip import bessel_basis as jax_bessel_basis
from repro.graph.nequip import poly_envelope as jax_poly_envelope
from repro.graph.triplets import build_triplets as jax_triplets
from repro_torch.configs import get_arch
from repro_torch.graph import so3
from repro_torch.graph.dimenet import angular_basis
from repro_torch.graph.nequip import allowed_paths, bessel_basis, \
    poly_envelope
from repro_torch.graph.triplets import build_triplets


# ------------------------------------------------------------------ so3
@pytest.mark.parametrize("path", jax_allowed_paths(2))
def test_coupling_tensors_equal_jax(path):
    np.testing.assert_array_equal(so3.coupling_tensor(*path),
                                  jso3.coupling_tensor(*path))
    np.testing.assert_array_equal(so3.cg_matrix_complex(*path),
                                  jso3.cg_matrix_complex(*path))


def test_allowed_paths_and_real_basis_equal_jax():
    assert allowed_paths(2) == jax_allowed_paths(2) and \
        len(allowed_paths(2)) == 15
    for l in range(3):
        np.testing.assert_array_equal(so3.real_basis_change(l),
                                      jso3.real_basis_change(l))


def test_real_sph_harm_and_grads_match_jax():
    v = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    v[0] = 0.0                                    # the eps inside the norm
    w = {l: np.random.default_rng(l).normal(size=(50, 2 * l + 1))
         for l in range(3)}
    want = jso3.real_sph_harm(jnp.asarray(v), 2)
    want_g = jax.grad(lambda x: sum(jnp.sum(y * w[l]) for l, y in
                                    jso3.real_sph_harm(x, 2).items()))(
        jnp.asarray(v))
    x = torch.as_tensor(v).requires_grad_()
    got = so3.real_sph_harm(x, 2)
    (got_g,) = torch.autograd.grad(sum((y * torch.as_tensor(w[l])).sum()
                                       for l, y in got.items()), x)
    for l in range(3):
        gp.assert_close(got[l].detach(), want[l], f"Y_{l}")
    gp.assert_close(got_g, want_g, "Y grads")
    with pytest.raises(NotImplementedError):
        so3.real_sph_harm(x, 3)


def test_l1_conventions_hold():
    assert so3.check_l1_conventions() < 1e-9     # eps 1e-9 inside the norm
    assert jso3.check_l1_conventions() < 1e-6


def test_real_sph_harm_rotates_as_the_coupling_basis_says():
    """D^1(R) = P R P^T on the (y, z, x) basis: Y_1(R v) = P R P^T Y_1(v)."""
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = q * np.sign(np.linalg.det(q))
    v = rng.normal(size=(20, 3))
    P = np.eye(3)[[1, 2, 0]]
    y = so3.real_sph_harm(torch.as_tensor(v), 1)[1].numpy()
    yr = so3.real_sph_harm(torch.as_tensor(v @ R.T), 1)[1].numpy()
    np.testing.assert_allclose(yr, y @ (P @ R @ P.T).T, atol=1e-9)


# --------------------------------------------------------------- bases
def test_bessel_basis_and_envelope_match_jax():
    r = np.array([0.0, 1e-7, 0.3, 1.0, 2.5, 4.99, 5.0, 7.0], np.float32)
    got = bessel_basis(torch.as_tensor(r), 8, 5.0)
    gp.assert_close(got, jax_bessel_basis(jnp.asarray(r), 8, 5.0), "bessel")
    x = np.linspace(0, 1.2, 13).astype(np.float32)
    gp.assert_close(poly_envelope(torch.as_tensor(x)),
                    jax_poly_envelope(jnp.asarray(x)), "envelope")


def test_angular_basis_and_its_gradient_at_the_clip_match_jax():
    """cos = -1 exactly is where padded triplets sit; the clip's gradient
    splits at the tie in both packages (maximum / minimum), finite."""
    c = np.array([-1.0, -1.0000001, -0.5, 0.0, 0.7, 1.0, 1.0000001],
                 np.float32)
    w = np.random.default_rng(2).normal(size=(7, 7))
    want = jax_angular_basis(jnp.asarray(c), 7)
    want_g = jax.grad(lambda x: jnp.sum(jax_angular_basis(x, 7) * w))(
        jnp.asarray(c))
    x = torch.as_tensor(c).requires_grad_()
    got = angular_basis(x, 7)
    (got_g,) = torch.autograd.grad((got * torch.as_tensor(w)).sum(), x)
    gp.assert_close(got.detach(), want, "angular basis")
    gp.assert_close(got_g, want_g, "angular basis grad")
    assert bool(torch.isfinite(got_g).all())


# --------------------------------------------------------------- models
def _molecule(seed, model_name, t_factor=4):
    """A connected numpy molecule batch, with triplets for DimeNet (capped
    at t_factor x the padded edge count, so the tail is padding)."""
    b = gp.molecule_batch(seed)
    if model_name == "dimenet":
        E = int(b["edge_mask"].sum())
        kj, ji, m = build_triplets(b["senders"][:E], b["receivers"][:E],
                                   len(b["x"]), t_factor * len(b["senders"]))
        b.update(t_kj=kj, t_ji=ji, t_mask=m)
    return b


def _jax_loss(model, params, batch, needs_triplets):
    g = gp.jax_graph(batch, 128)
    extra = ((jnp.asarray(batch["t_kj"]), jnp.asarray(batch["t_ji"]),
              jnp.asarray(batch["t_mask"])) if needs_triplets else ())
    return jnp.mean(jnp.square(model(params, g, *extra)
                               - jnp.asarray(batch["targets"])))


@pytest.fixture(scope="module", params=["nequip", "dimenet"])
def geo_case(request):
    """The reduced model at `molecule` (energy MSE): JAX's forward, loss,
    gradients and two train steps (one jit), the port's model loaded with
    the same parameters."""
    name = request.param
    jmodel = jax_get_arch(name).build_reduced("molecule")
    pmodel = get_arch(name).build_reduced("molecule", device="cpu")
    params = jmodel.init(jax.random.key(5))
    gp.load_jax_params(pmodel, params)
    batch = _molecule(6, name)
    trip = name == "dimenet"
    ref, runs = gp.jax_reference(
        lambda p, b: _jax_loss(jmodel, p, b, trip),
        jax_get_arch(name).step(jmodel, "molecule"), params,
        {"molecule": batch}, "molecule")
    extra = ((jnp.asarray(batch["t_kj"]), jnp.asarray(batch["t_ji"]),
              jnp.asarray(batch["t_mask"])) if trip else ())
    fwd = np.asarray(jmodel(params, gp.jax_graph(batch, 128), *extra))
    return dict(name=name, pmodel=pmodel, batch=batch, fwd=fwd, ref=ref,
                runs=runs, trip=trip)


def _port_extra(c, pb):
    return (pb["t_kj"], pb["t_ji"], pb["t_mask"]) if c["trip"] else ()


def test_geometric_forward_matches_jax(geo_case):
    c = geo_case
    pb = gp.port_batch(c["batch"])
    out = c["pmodel"](gp.port_graph(c["batch"], 128), *_port_extra(c, pb))
    gp.assert_close(out.detach(), c["fwd"], f"{c['name']} forward")


def test_geometric_loss_and_grads_match_jax(geo_case):
    c = geo_case
    step = get_arch(c["name"]).step(c["pmodel"], "molecule")
    loss, grads = gp.port_grads(c["pmodel"], step.loss_fn,
                                gp.port_batch(c["batch"]))
    want_loss, want_grads = c["ref"]["molecule"]
    assert abs(loss - want_loss) <= gp.FWD_TOL * abs(want_loss)
    gp.assert_leaves_close(grads, want_grads, f"{c['name']} grads")


def test_geometric_train_steps_match_jax(geo_case):
    c = geo_case
    model = get_arch(c["name"]).build_reduced("molecule", device="cpu")
    model.load_state_dict(c["pmodel"].state_dict())
    runs = gp.port_runs(get_arch(c["name"]).step(model, "molecule"), model,
                        c["batch"])
    gp.assert_runs_close(runs, c["runs"], c["name"])


@pytest.mark.parametrize("geo_case", ["dimenet"], indirect=True)
def test_dimenet_padded_triplets_sit_at_the_clip_with_finite_grads(
        geo_case):
    """Padded triplets (t_kj = t_ji = 0) read edge 0 against itself: cos
    -1 (the clip's boundary); the gradient stays finite (t_mask drops
    their messages) and equals JAX's (test_geometric_loss_and_grads_...)."""
    c = geo_case
    pb = gp.port_batch(c["batch"])
    g = gp.port_graph(c["batch"], 128)
    pad = ~pb["t_mask"]
    assert int(pad.sum()) > 0
    vec = g.pos[g.receivers[0]] - g.pos[g.senders[0]]
    cos = -(vec * vec).sum() / torch.linalg.vector_norm(vec + 1e-9) ** 2
    assert abs(float(cos) + 1.0) <= 1e-6
    step = get_arch("dimenet").step(c["pmodel"], "molecule")
    _, grads = gp.port_grads(c["pmodel"], step.loss_fn, pb)
    assert all(np.isfinite(v).all() for v in gp._leaves(grads).values())


def test_triplets_of_the_molecule_batch_equal_jax():
    b = gp.molecule_batch(6)
    E = int(b["edge_mask"].sum())
    for a, w in zip(build_triplets(b["senders"][:E], b["receivers"][:E], 48,
                                   416),
                    jax_triplets(b["senders"][:E], b["receivers"][:E], 48,
                                 416)):
        np.testing.assert_array_equal(a, w)


def test_nequip_energy_is_rotation_invariant():
    model = get_arch("nequip").build_reduced("molecule", device="cpu")
    b = gp.molecule_batch(8)
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    e = model(gp.port_graph(b, 128)).detach().numpy()
    b["pos"] = b["pos"] @ rot.T + np.float32(1.5)
    e_rot = model(gp.port_graph(b, 128)).detach().numpy()
    np.testing.assert_allclose(e_rot, e, rtol=1e-4, atol=1e-4)
