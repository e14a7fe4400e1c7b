"""The port's Mixture-of-Experts (repro_torch.nn.moe, dist.moe_ep), the
four LM configs it completes (moonshot-v1-16b-a3b, llama4-maverick-400b-
a17b, internlm2-20b, mistral-large-123b) and nn.initializers against
the JAX package on the CPU. Parameters come from the JAX `init`s,
converted (`convert`); data from numpy seeds.

Tolerances (f32):
  * MoELayer's sorted dispatch (with drops, T > 4 E, and dropless) and
    dense_oracle, outputs and the aux loss: |port - jax| <= 1e-5 * (1 +
    |jax|); input and parameter gradients through the dispatch per leaf
    within 1e-4 of the leaf's max;
  * routing, `segment_positions` and the capacity: equal; at a tie the
    lower expert index wins, as jax.lax.top_k orders it;
  * the four REDUCED TransformerLMs (test_torch_train_zoo.py's bounds):
    logits 1e-4 * (1 + |jax|); 8 greedy decode steps from an empty cache
    with equal tokens, logits 2e-4 * (1 + |jax|); the loss (with 0.01 x
    the load-balance aux of the MoE configs) within 1e-5 * |jax|; its
    gradients per leaf within 1e-4 of the leaf's max; after one
    lm_step("train_4k") with Adam and with 8-bit Adam, the parameters
    within 1e-5 absolute (2 lr + 1e-5 where JAX's gradient lies within the
    gradients' bound of 0, so that rounding may turn Adam's sign step:
    `assert_first_adam_step_close`), Adam's moments within 1e-5 absolute
    and 1e-4 of each leaf's max; the
    8-bit state's int8 codes differing by at most one in at most 1 in
    1,000 elements (where m / scale lies within rounding of a half) and
    its block scales within 1e-4 of each leaf's max
    (test_torch_train_zoo.py's checks). Its dequantized moments are not
    held to 1e-5 absolute: a code one step off moves its moment by the
    block's scale, 1.4e-5 in moonshot's embedding table;
  * expert parallelism on 2 gloo ranks (`launch/mesh.py:
    spawn_stream_mesh`, CPU tensors): at capacity_factor 8 (nothing
    drops) the gathered outputs equal JAX's dense_oracle within 1e-5 *
    (1 + |jax|); at 1.25, with drops, JAX's own `moe_ep_apply` on a forced
    2-device CPU mesh (a subprocess), within the same bound. The EP
    path's aux loss is 0 in both packages (ROADMAP R18);
  * the initializers' draws (torch cannot reproduce jax.random): the
    sample std within 3% of the target's, truncated draws within 2
    sigma, uniform ones within +-sqrt(3 var); `batch_axes` takes the
    batch axes out of the fans, and JAX's draws of the same shape have
    the same std within 3%.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import lm_step as jax_lm_step
from repro.configs.base import make_optimizer as jax_make_optimizer
from repro.data.streams import token_batches as jax_token_batches
from repro.nn import initializers as jinit
from repro.nn.moe import MoEConfig as JaxMoEConfig
from repro.nn.moe import MoELayer as JaxMoELayer
from repro.nn.moe import _segment_positions as jax_segment_positions
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import lm_step, make_optimizer, value_and_grad
from repro_torch.dist.moe_ep import moe_ep_apply
from repro_torch.launch.mesh import spawn_stream_mesh
from repro_torch.nn import initializers as init
from repro_torch.nn.module import param_tree
from repro_torch.nn.moe import (MoEConfig, MoELayer, capacity,
                                segment_positions, top_k)
from test_torch_train_zoo import (_leaves, _pairs, _scales,
                                  assert_grads_close,
                                  assert_loss_close, assert_moments_close,
                                  assert_trees_close)

REPO = Path(__file__).resolve().parents[1]
FWD_TOL, GRAD_TOL, LOGIT_TOL, DECODE_TOL, STATE_TOL = 1e-5, 1e-4, 1e-4, \
    2e-4, 1e-5
ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
         "internlm2-20b", "mistral-large-123b")
D_MODEL = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of these tests runs on small tensors: one intra-op
    thread, so that beside the suite's other workers it does not
    oversubscribe the CPU (a first train step took 114 s with 8 threads
    beside 5 busy processes, 9 s with one); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), \
        f"{what}: max err {err.max()}"


# ------------------------------------------------------------- the layer
def port_moe_config(jcfg):
    """The port's MoEConfig of a JAX one (the port has no dp_axes: each
    rank holds its own tokens)."""
    return MoEConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                        if k != "dp_axes"})


def layer_case(n_shared, cf, T, seed=0):
    """A JAX MoELayer (4 experts, top-2, d_ff 16) with its init, the port's
    layer loaded from it, and tokens x [T, 32] whose mean leans toward
    experts 0 and 1, so that past 4 E tokens the capacity drops pairs."""
    jcfg = JaxMoEConfig(num_experts=4, top_k=2, d_ff=16, n_shared=n_shared,
                        capacity_factor=cf)
    jl = JaxMoELayer(D_MODEL, jcfg)
    params = jl.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    router = rng.normal(scale=0.3, size=(D_MODEL, 4)).astype(np.float32)
    lean = np.zeros(D_MODEL, np.float32)
    lean[:4] = 1.0
    router[:4, :2] += 1.0
    params = dict(params, router=jnp.asarray(router))
    x = (rng.normal(size=(T, D_MODEL)) + lean).astype(np.float32)
    port = MoELayer(D_MODEL, port_moe_config(jcfg), device="cpu")
    port.load_state_dict(convert._tensors(
        {k: np.asarray(v) for k, v in convert._flatten(params)}))
    return jl, params, port, x


def dropped_pairs(port, x):
    """(token, expert) pairs the sorted dispatch drops on x."""
    ids = port.route(torch.tensor(x))[0].reshape(-1)
    E, K = port.cfg.num_experts, port.cfg.top_k
    C = capacity(x.shape[0], K, port.cfg.capacity_factor, E, E)
    return int(torch.clamp(torch.bincount(ids, minlength=E) - C,
                           min=0).sum())


@pytest.mark.parametrize("n_shared,cf,T,drops", [
    (0, 1.25, 96, True), (2, 1.25, 96, True), (2, 2.0, 16, False),
    (1, 1.0, 8, False)])
def test_moe_layer_matches_jax(n_shared, cf, T, drops):
    jl, params, port, x = layer_case(n_shared, cf, T)
    assert (dropped_pairs(port, x) > 0) == drops
    want, jaux = jax.jit(jl.__call__)(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got, aux = port(xt)
    close(_np(got), want, FWD_TOL, "dispatch")
    close(float(aux.detach()), float(jaux), FWD_TOL, "aux")
    # gradients through the dispatch: x, the router and every expert
    def jloss(xx, p):
        out, a = jl(p, xx)
        return jnp.sum(jnp.sin(out)) + a

    def ploss(xx):
        out, a = port(xx)
        return torch.sin(out).sum() + a

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                                         params)
    _, grads = value_and_grad(port, ploss, param_tree(port),
                              torch.tensor(x))
    ploss(xt).backward()
    scale = np.abs(np.asarray(jgx)).max()
    close(_np(xt.grad) / scale, np.asarray(jgx) / scale, GRAD_TOL, "dx")
    flat = {k: np.asarray(v) for k, v in convert._flatten(jgp)}
    assert flat.keys() == grads.keys()
    for k, w in flat.items():
        err = float(np.abs(_np(grads[k]) - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (k, err)


@pytest.mark.parametrize("n_shared,cf,T", [(2, 1.25, 96), (0, 2.0, 16)])
def test_dense_oracle_matches_jax_and_the_dropless_dispatch(n_shared, cf,
                                                            T):
    jl, params, port, x = layer_case(n_shared, cf, T)
    want, jaux = jax.jit(jl.dense_oracle)(params, jnp.asarray(x))
    got, aux = port.dense_oracle(torch.tensor(x))
    close(_np(got), want, FWD_TOL, "dense_oracle")
    close(float(aux), float(jaux), FWD_TOL, "aux")
    # with capacity to spare the dispatch is the oracle
    ample = MoELayer(D_MODEL, dataclasses.replace(port.cfg,
                                                  capacity_factor=64.0),
                     device="cpu")
    ample.load_state_dict(port.state_dict())
    close(_np(ample(torch.tensor(x))[0]), _np(got), FWD_TOL, "ample")


def test_segment_positions_and_capacity_match_jax():
    rng = np.random.default_rng(3)
    for n, E in ((50, 4), (1, 3), (200, 16)):
        ids = np.sort(rng.integers(0, E, n))
        np.testing.assert_array_equal(
            _np(segment_positions(torch.tensor(ids), E)),
            np.asarray(jax_segment_positions(jnp.asarray(ids), E)))
    # decode-sized T is dropless; otherwise Python float arithmetic
    assert capacity(32, 6, 1.25, 64, 64) == 32 * 6
    assert capacity(32768, 6, 1.25, 64, 64) == 3840
    assert capacity(2048, 6, 1.25, 4, 64) == 3840
    assert capacity(257, 3, 0.001, 64, 64) == 1


def test_ties_break_toward_the_lower_expert_as_jax():
    p = np.array([[.25, .25, .25, .25, 0, 0], [0, .5, 0, .5, 0, 0]],
                 np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(p), 3)[1])
    np.testing.assert_array_equal(_np(top_k(torch.tensor(p), 3)[1]), want)
    np.testing.assert_array_equal(want[0], [0, 1, 2])
    # a zero router: every expert equally likely, so the first k win
    jl, params, port, x = layer_case(0, 1.25, 8)
    with torch.no_grad():
        port.router.zero_()
    params = dict(params, router=jnp.zeros((D_MODEL, 4)))
    np.testing.assert_array_equal(
        _np(port.route(torch.tensor(x))[0]),
        np.asarray(jl.route(params, jnp.asarray(x))[0]))
    np.testing.assert_array_equal(_np(port.route(torch.tensor(x))[0]),
                                  np.tile([0, 1], (8, 1)))


def test_ep_axis_without_a_mesh_raises():
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff=16, ep_axis=("model",))
    with pytest.raises(ValueError, match="mesh"):
        MoELayer(D_MODEL, cfg, device="cpu")(torch.zeros(4, D_MODEL))


# -------------------------------------------------------- initializers
@pytest.mark.parametrize("name,shape,batch_axes,var", [
    ("lecun_normal", (64, 256), (), 1 / 64),
    ("lecun_normal", (8, 64, 96), (0,), 1 / 64),
    ("lecun_normal", (8, 64, 96), (), 1 / 512),
    ("glorot_uniform", (128, 64), (), 2 / 192),
    ("glorot_normal", (4, 96, 32), (0,), 2 / 128),
    ("he_normal", (256, 64), (), 2 / 256),
])
def test_variance_scaling_draws(name, shape, batch_axes, var):
    w = getattr(init, name)(shape, torch.Generator().manual_seed(0),
                            batch_axes=batch_axes)
    assert w.shape == shape and w.dtype == torch.float32
    std = float(w.std())
    assert abs(std - var ** 0.5) <= 0.03 * var ** 0.5, (std, var ** 0.5)
    if name.endswith("normal"):
        trunc_std = var ** 0.5 / init.TRUNC_STD
        assert float(w.abs().max()) <= 2 * trunc_std + 1e-6
    else:
        assert float(w.abs().max()) <= (3 * var) ** 0.5 + 1e-6
    jw = np.asarray(getattr(jinit, name)(jax.random.key(0), shape,
                                         batch_axes=batch_axes))
    assert abs(std - jw.std()) <= 0.03 * jw.std(), (std, jw.std())


def test_variance_scaling_modes_and_refusals():
    g = torch.Generator().manual_seed(1)
    w = init.variance_scaling(3.0, "fan_out", "normal")((512, 32), g)
    assert abs(float(w.std()) - (3 / 32) ** 0.5) <= 0.03 * (3 / 32) ** 0.5
    with pytest.raises(ValueError):
        init.variance_scaling(1.0, "fan_sum", "normal")
    with pytest.raises(ValueError):
        init.variance_scaling(1.0, "fan_in", "cauchy")


def test_expert_slabs_draw_per_expert_fans():
    cfg = MoEConfig(num_experts=16, top_k=2, d_ff=96)
    lay = MoELayer(64, cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("wg", 64), ("wu", 64), ("wd", 96)):
        std = float(getattr(lay, name).std())
        assert abs(std - fan_in ** -0.5) <= 0.03 * fan_in ** -0.5, name
    assert abs(float(lay.router.std()) - 0.006) <= 0.03 * 0.006


# ----------------------------------------------------- the four configs
@pytest.fixture(scope="module", params=ARCHS)
def lm_case(request):
    """(arch, JAX's init (numpy), JAX's results): logits of tokens [2,
    32]; 8 greedy decode steps (B 4) from an empty cache; the loss and
    its gradients on [2, 32] with padding; one lm_step("train_4k") per
    optimizer on [256, 16] tokens at grad_accum 8."""
    arch = request.param
    model = jax_get_arch(arch).build_reduced()
    params = jax.jit(model.init)(jax.random.key(0))
    c = model.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, c.vocab, (2, 32)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -100
    first = rng.integers(0, c.vocab, (4, 1)).astype(np.int32)

    logits = jax.jit(model.logits)(params, jnp.asarray(toks))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, jnp.asarray(toks), jnp.asarray(labels))
    decode = jax.jit(model.decode_step)
    cache, tok, steps = model.init_cache(4, 16), jnp.asarray(first), []
    for _ in range(8):
        lg, cache = decode(params, cache, tok)
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        steps.append((tok, lg))
    data = list(jax_token_batches(0, c.vocab, 256, 16, 1))[0]
    stepped = {}
    for opt in ("adam", "adam8bit"):
        step = jax.jit(jax_lm_step(model, "train_4k", grad_accum=8,
                                   opt_name=opt))
        p1, s1, l1 = step(params, jax_make_optimizer(opt).init(params),
                          jnp.asarray(data[0]), jnp.asarray(data[1]))
        stepped[opt] = (float(l1), jax.tree.map(np.asarray, p1),
                        jax.tree.map(np.asarray, s1))
    return arch, jax.tree.map(np.asarray, params), {
        "toks": toks, "labels": labels, "first": first,
        "logits": np.asarray(logits), "loss": float(loss),
        "grads": jax.tree.map(np.asarray, grads),
        "decode": [(np.asarray(t), np.asarray(lg)) for t, lg in steps],
        "data": data, "stepped": stepped}


def assert_first_adam_step_close(got, want, m, what, lr=3e-4, b1=0.9):
    """Parameters after the first Adam step, per leaf: within STATE_TOL
    of JAX's, except where JAX's gradient g = m / (1 - b1) lies within
    the gradients' own bound (GRAD_TOL of the leaf's max) of 0. The step
    moves a parameter by lr g / (|g| + eps), so there the two packages'
    rounding may give it either sign: such an element is held within
    2 lr + STATE_TOL (llama4-maverick's reduced wv has one, g = 1.3e-8
    in JAX, 5.7e-9 in the port, against a leaf max of 0.0147)."""
    g, w = _leaves(got), _leaves(want)
    grads = {k: v / (1 - b1) for k, v in _leaves(m).items()}
    assert g.keys() == w.keys() == grads.keys(), what
    for k in w:
        err = np.abs(g[k].astype(np.float64) - w[k])
        noise = np.abs(grads[k]) <= GRAD_TOL * np.abs(grads[k]).max()
        bound = np.where(noise, 2 * lr + STATE_TOL, STATE_TOL)
        assert np.all(err <= bound), f"{what} {k}: max err {err.max()}"


def port_model(arch, tree):
    spec = get_arch(arch)
    model = spec.build_reduced(device="cpu", train=True)
    model.load_state_dict(convert.lm_params_from_numpy(tree, model.cfg,
                                                       torch.float32))
    return model


def test_reduced_lm_forward_and_decode_match_jax(lm_case):
    arch, tree, ref = lm_case
    model = port_model(arch, tree)
    assert (model.cfg.moe is not None) == (arch in ARCHS[:2])
    close(_np(model.logits(torch.tensor(ref["toks"]))), ref["logits"],
          LOGIT_TOL, f"{arch} logits")
    cache = model.init_cache(4, 16)
    tok = torch.tensor(ref["first"])
    for want_tok, want_lg in ref["decode"]:
        lg, cache = model.decode_step(cache, tok)
        close(_np(lg), want_lg, DECODE_TOL, f"{arch} decode logits")
        tok = torch.argmax(lg[:, -1:], dim=-1)
        np.testing.assert_array_equal(_np(tok), want_tok)


def test_reduced_lm_loss_and_grads_match_jax(lm_case):
    arch, tree, ref = lm_case
    model = port_model(arch, tree)
    loss, grads = value_and_grad(model, model.loss, param_tree(model),
                                 torch.tensor(ref["toks"]),
                                 torch.tensor(ref["labels"]))
    assert_loss_close(loss, ref["loss"])
    layout = convert.LMLayout(model.cfg)
    assert_grads_close(convert.params_to_numpy(grads, layout), ref["grads"],
                       f"{arch} grads")
    if model.cfg.moe is not None:
        # the loss carries 0.01 x the summed load-balance aux, which the
        # bound could not miss
        with torch.no_grad():
            aux = model._hidden(torch.tensor(ref["toks"]))[1]
        assert abs(float(loss) - 0.01 * float(aux) - ref["loss"]) > \
            1e-5 * abs(ref["loss"])


@pytest.mark.parametrize("opt_name", ["adam", "adam8bit"])
def test_reduced_lm_train_step_matches_jax(lm_case, opt_name):
    arch, tree, ref = lm_case
    model = port_model(arch, tree)
    step = lm_step(model, "train_4k", grad_accum=8, opt_name=opt_name)
    params = param_tree(model)
    toks, labels = ref["data"]
    params, state, loss = step(params, make_optimizer(opt_name).init(params),
                               torch.tensor(toks), torch.tensor(labels))
    jloss, jparams, jstate = ref["stepped"][opt_name]
    assert_loss_close(loss, jloss)
    layout = convert.LMLayout(model.cfg)
    assert_first_adam_step_close(
        convert.params_to_numpy(params, layout), jparams,
        ref["stepped"]["adam"][2]["m"], f"{arch} params")
    got = convert.opt_state_to_numpy(state, layout)
    assert int(got["t"]) == int(jstate["t"]) == 1
    if opt_name == "adam":
        assert_moments_close({"m": got["m"], "v": got["v"]},
                             {"m": jstate["m"], "v": jstate["v"]},
                             f"{arch} adam moments")
    else:
        codes = [pair for _, pair in _pairs(got, jstate)]
        off = sum(int((np.abs(g.astype(int) - w) > 1).sum())
                  for g, w in codes)
        near = sum(int((g != w).sum()) for g, w in codes)
        total = sum(w.size for _, w in codes)
        assert off == 0 and near <= total // 1000, (off, near, total)
        assert_moments_close(_scales(got), _scales(jstate),
                             f"{arch} adam8bit block scales")
    # JAX's state goes into the port and back unchanged
    back = convert.opt_state_to_numpy(
        convert.opt_state_from_numpy(jstate, layout), layout)
    assert_trees_close(back, jstate, 0.0, f"{arch} state round trip")


def test_reduced_archs_train_through_the_launcher():
    from repro_torch.launch import train as train_cli
    for arch in ARCHS[:2]:
        _, _, _, losses = train_cli.main(
            ["--arch", arch, "--shape", "train_4k", "--steps", "1",
             "--reduced", "--device", "cpu"])
        assert len(losses) == 1 and np.isfinite(losses[0])


# ------------------------------------------------- expert parallelism
EP_RANKS, EP_T = 2, 48          # tokens a rank (> 4 E: capacity applies)


def _ep_rank(mesh, sd, x, cf):
    """This rank's tokens through the EP path of a 4-expert layer, twice:
    the layer's `_ep_call` (the full layer sliced to the rank's slab) and
    `moe_ep_apply` on the slab alone; the gradient of x; the calls."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff=16, n_shared=1,
                    capacity_factor=cf, ep_axis=("model",))
    lay = MoELayer(D_MODEL, cfg, device="cpu")
    lay.load_state_dict(sd)
    lo = mesh.rank * EP_T
    xl = torch.tensor(x[lo:lo + EP_T], requires_grad=True)
    out, aux = lay(xl, mesh=mesh)
    out.sum().backward()
    e_loc = 2
    slab = {"router": lay.router, **{n: getattr(lay, n)[
        mesh.rank * e_loc:(mesh.rank + 1) * e_loc] for n in ("wg", "wu",
                                                               "wd")}}
    direct = moe_ep_apply(lay, slab, xl.detach(), mesh)
    return _np(out), float(aux), _np(xl.grad), _np(direct), dict(mesh.calls)


def _ep_case(cf):
    jl, params, port, x = layer_case(1, cf, EP_RANKS * EP_T, seed=2)
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    return jl, params, port, x, sd


def test_ep_matches_jax_dense_oracle_at_ample_capacity():
    jl, params, port, x, sd = _ep_case(8.0)
    ranks = spawn_stream_mesh(EP_RANKS, _ep_rank, backend="gloo",
                              device="cpu", args=(sd, x, 8.0), timeout=300)
    want, _ = jax.jit(jl.dense_oracle)(params, jnp.asarray(x))
    got = np.concatenate([r[0] for r in ranks])
    close(got, want, FWD_TOL, "EP vs dense_oracle")
    close(np.concatenate([r[3] for r in ranks]), want, FWD_TOL,
          "moe_ep_apply on the slab")
    # the gradient of the tokens through the exchanges and back
    jgx = jax.jit(jax.grad(lambda xx: jnp.sum(jl.dense_oracle(params,
                                                              xx)[0])))(
        jnp.asarray(x))
    close(np.concatenate([r[2] for r in ranks]) / np.abs(jgx).max(),
          np.asarray(jgx) / np.abs(jgx).max(), GRAD_TOL, "EP dx")
    # R18: the EP path's aux is 0
    assert [r[1] for r in ranks] == [0.0] * EP_RANKS
    calls = ranks[0][4]
    # rows and expert ids out, rows back, for each of the two forwards;
    # the backward exchanges the row cotangents twice
    assert calls["all_to_all"][0] == 6 and \
        calls["all_to_all backward"][0] == 2


# JAX's moe_ep_apply and `_ep_call` on a forced 2-device CPU mesh: the
# layer's config, parameters and tokens come in a pickle, the outputs go
# out in another (a fresh process: the device count is fixed at start)
JAX_EP = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist.moe_ep import moe_ep_apply
from repro.nn.moe import MoEConfig, MoELayer
with open(sys.argv[1], "rb") as f:
    case = pickle.load(f)
jl = MoELayer(case["d"], MoEConfig(**case["cfg"]))
params = jax.tree.map(jnp.asarray, case["params"])
x = jnp.asarray(case["x"])
mesh = jax.make_mesh((2,), ("model",))
specs = {"router": P(), "wg": P("model"), "wu": P("model"),
         "wd": P("model"), "shared": {k: P() for k in ("wg", "wu", "wd")}}
fn = jax.shard_map(lambda p, xx: moe_ep_apply(jl, p, xx, "model"),
                   mesh=mesh, in_specs=(specs, P("model", None)),
                   out_specs=P("model", None), check_vma=False)
out = jax.jit(fn)(params, x)
ep = MoELayer(case["d"], MoEConfig(**dict(case["cfg"], ep_axis=("model",),
                                          dp_axes=("model",))))
with jax.set_mesh(mesh):
    ep_out, ep_aux = jax.jit(ep.__call__)(params, x)
with open(sys.argv[2], "wb") as f:
    pickle.dump({"out": np.asarray(out), "ep_out": np.asarray(ep_out),
                 "ep_aux": float(ep_aux),
                 "aux": float(jax.jit(jl.__call__)(params, x)[1])}, f)
"""


def test_ep_with_drops_matches_jax_moe_ep_apply(tmp_path):
    cf = 1.25
    jl, params, port, x, sd = _ep_case(cf)
    in_path, out_path = tmp_path / "case.pkl", tmp_path / "jax_ep.pkl"
    with open(in_path, "wb") as f:
        pickle.dump({"d": D_MODEL, "cfg": dataclasses.asdict(jl.cfg),
                     "params": jax.tree.map(np.asarray, params), "x": x}, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{EP_RANKS} --xla_backend_optimization_level=0")
    proc = subprocess.Popen([sys.executable, "-c", JAX_EP, str(in_path),
                             str(out_path)], env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ranks = spawn_stream_mesh(EP_RANKS, _ep_rank, backend="gloo",
                                  device="cpu", args=(sd, x, cf),
                                  timeout=300)
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        ref = pickle.load(f)
    # some pairs drop: per-rank capacity T K cf / S
    ids = _np(port.route(torch.tensor(x))[0])
    C = capacity(EP_T, 2, cf, EP_RANKS, 4)
    dropped = sum(max(0, int((ids[r * EP_T:(r + 1) * EP_T] // 2 == q).sum())
                      - C) for r in range(EP_RANKS) for q in range(EP_RANKS))
    assert dropped > 0
    got = np.concatenate([r[0] for r in ranks])
    close(got, ref["out"], FWD_TOL, "EP with drops vs JAX moe_ep_apply")
    close(ref["ep_out"], ref["out"], FWD_TOL, "JAX _ep_call")
    # R18, pinned in both packages: the EP path's aux loss is 0 where the
    # same layer's single-device call has one
    assert ref["ep_aux"] == 0.0 and ref["aux"] > 0
    assert [r[1] for r in ranks] == [0.0] * EP_RANKS

