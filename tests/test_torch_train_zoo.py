"""The zoo's train steps in the port (repro_torch: data.streams
token_batches, nn.attention.mha_chunked and the training route,
TransformerLM.loss, configs.base lm_step("train_4k") / make_optimizer,
TwoTower.loss, the two-tower train_batch step, kernels.embedding_bag's
autograd.Function, convert's parameter and optimizer-state carriers, the
launch.train launcher) against the JAX package on the CPU. Parameters
come from the JAX `init`s, converted (`convert`); data from numpy seeds.

Tolerances (f32):
  * token batches: arrays equal;
  * losses: |port - jax| <= 1e-5 * |jax|;
  * gradients: per leaf, max |port - jax| <= 1e-4 * max |jax| (the leaf's
    scale: f32 sums in another order over 4 layers);
  * after a train step, parameters and Adam's moments (m, v, and the
    dequantized 8-bit moments) within 1e-5 absolute, t equal; m, v and
    the 8-bit block scales also per leaf within 1e-4 x max |jax| (the
    gradients' bound: v ~ 1e-3 g^2 lies far below 1e-5, so the absolute
    bound alone would pass any v of that size). Adam's
    first step moves each parameter by lr * g / (|g| + eps), about
    lr * sign(g), so an element whose gradient lies within the two
    packages' rounding of 0 could move the other way (2 * lr = 6e-4
    apart); no leaf here has one, and none is exempt. The 8-bit state's
    int8 codes may differ by one where m / scale lies within rounding of
    a half: codes are compared through the dequantized moments, whose
    bound absorbs a code step only when the block's scale is small, so
    the codes are also required to differ by at most 1 in at most 1 in
    1,000 elements;
  * the launcher: the same step lines (format and count) as JAX's
    launcher on the same parameters and data, losses within 1e-4 * |jax|
    (printed to 4 decimals).
With bf16 compute over f32 parameters (the published config's dtype):
  * losses: |port - jax| <= 2^-8 * |jax| (bf16's unit roundoff);
  * gradients, parameters and Adam's moments after a step: per leaf,
    ||port - jax||_2 <= 2 x ||jax_f32 - jax||_2, twice the distance that
    bf16 rounding puts between the reference's own f32 and bf16 runs
    (the port measures 0.6-1.02 of it: XLA and torch round in other
    places, and a gradient element that bf16 takes across 0 turns
    Adam's sign step).
The embedding-bag backward (the autograd.Function's plain path) is held
to torch.autograd through `embedding_bag_ref`, and to jax.grad through
the reference lookup, within 1e-6 * (1 + |ref|).
The JAX results are computed once per module (module-scoped fixtures).
"""
import dataclasses
import re
import sys
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import lm_step as jax_lm_step
from repro.configs.base import make_optimizer as jax_make_optimizer
from repro.configs.mistral_nemo_12b import REDUCED as JAX_REDUCED
from repro.configs import two_tower_retrieval as jax_tt_cfg
from repro.data.streams import token_batches as jax_token_batches
from repro.nn.attention import mha_chunked as jax_mha_chunked
from repro.nn.transformer import TransformerLM as JaxTransformerLM
from repro.recsys.embedding_bag import embedding_bag_lookup as jax_bag
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs import two_tower_retrieval as tt_cfg
from repro_torch.configs.base import (ArchSpec, lm_step, make_optimizer,
                                      value_and_grad)
from repro_torch.configs.mistral_nemo_12b import REDUCED
from repro_torch.data.streams import token_batches
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.launch import train as train_cli
from repro_torch.nn import attention
from repro_torch.nn.module import bound_params, param_tree
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import adam
from repro_torch.optim.quantized import dequantize_blockwise
from repro_torch.recsys import two_tower
from repro_torch.recsys.two_tower import TwoTower

LM_ARCH, TT_ARCH = "mistral-nemo-12b", "two-tower-retrieval"
LOSS_TOL, GRAD_TOL, STATE_TOL = 1e-5, 1e-4, 1e-5
MOMENT_RTOL = 1e-4
BF16_U, BF16_GAP = 2.0 ** -8, 2.0
# the reduced LM at q_chunk 16 and S = 64: mha_chunked runs (4 blocks)
CHUNK_CFG = dataclasses.replace(REDUCED, q_chunk=16)
S_CHUNKED = 64
# lm_step("train_4k") on [256, 16] tokens, grad_accum 8: k = 8, m = 32
LM_STEP_SEQ, LM_ACCUM, N_STEPS = 16, 8, 2
TT_BATCH = 64


def _np(t):
    return t.detach().cpu().numpy()


def _leaves(tree, prefix=""):
    """{path: array} of a nested dict (QState tuples as leaves .0/.1)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_trees_close(got, want, atol, what):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys()))
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max()) \
            if w[k].size else 0.0
        assert err <= atol, f"{what} {k}: max err {err} > {atol}"


def assert_moments_close(got, want, what):
    """Adam's moments per leaf: within STATE_TOL absolute and within
    MOMENT_RTOL x max |want| of the leaf, whichever is tighter (v is
    ~1e-3 g^2, far below STATE_TOL, so the absolute bound alone would
    pass any v of that size)."""
    assert_trees_close(got, want, STATE_TOL, what)
    g, w = _leaves(got), _leaves(want)
    for k in w:
        scale = float(np.abs(w[k]).max()) if w[k].size else 0.0
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max()) \
            if w[k].size else 0.0
        assert err <= MOMENT_RTOL * scale, \
            f"{what} {k}: max err {err} > {MOMENT_RTOL} x {scale}"


def assert_grads_close(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys()))
    for k in w:
        scale = float(np.abs(w[k]).max())
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= GRAD_TOL * scale, \
            f"{what} {k}: max err {err} > {GRAD_TOL} x {scale}"


def assert_loss_close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


# ----------------------------------------------------------- token data
@pytest.mark.parametrize("seed,vocab,batch,seq,n", [
    (0, 512, 256, 16, 2), (3, 131072, 2, 64, 3), (7, 17, 5, 9, 1)])
def test_token_batches_equal_jax(seed, vocab, batch, seq, n):
    got = list(token_batches(seed, vocab, batch, seq, n))
    want = list(jax_token_batches(seed, vocab, batch, seq, n))
    assert len(got) == len(want) == n
    for (t, l), (jt, jl) in zip(got, want):
        assert t.dtype == jt.dtype and l.dtype == jl.dtype
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(l, jl)


# ---------------------------------------------------------- attention
@pytest.mark.parametrize("S,q_chunk,G,q_offset", [
    (64, 16, 2, 0), (48, 16, 1, 0), (32, 8, 4, 5)])
def test_mha_chunked_matches_jax(S, q_chunk, G, q_offset):
    rng = np.random.default_rng(S + q_chunk)
    Kh, D = 2, 16
    q = rng.normal(size=(2, S, Kh * G, D)).astype(np.float32)
    k = rng.normal(size=(2, S + q_offset, Kh, D)).astype(np.float32)
    v = rng.normal(size=(2, S + q_offset, Kh, D)).astype(np.float32)
    want = jax_mha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_chunk=q_chunk, q_offset=q_offset)
    got = attention.mha_chunked(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), q_chunk=q_chunk,
                                q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        attention.mha_chunked(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), q_chunk=S - 1)


def test_attention_routes_training_away_from_the_kernel():
    """A call that differentiates (grad mode on, the input requiring
    grad): mha_chunked when S > q_chunk, mha otherwise (JAX's route).
    Every other call, a serving model under grad mode included: the
    flash wrapper (prefill), which refuses exactly the calls routed
    away from it."""
    rng = np.random.default_rng(0)
    attn = attention.GQAAttention(32, 4, 2, 8, device="cpu", q_chunk=16,
                                  generator=torch.Generator().manual_seed(0))
    routes = ("mha_chunked", "mha", "flash_attention")
    real = {n: getattr(attention, n) for n in routes}
    for S, grad, needs, want in ((32, True, True, "mha_chunked"),
                                 (16, True, True, "mha"),
                                 (32, False, True, "flash_attention"),
                                 (32, True, False, "flash_attention")):
        x = torch.tensor(rng.normal(size=(2, S, 32)), dtype=torch.float32,
                         requires_grad=needs)
        with mock.patch.multiple(attention, **{
                n: mock.DEFAULT for n in routes}) as mocks:
            for n in routes:
                mocks[n].side_effect = real[n]
            with torch.set_grad_enabled(grad):
                attn(x)
        assert {n: m.call_count for n, m in mocks.items()} == {
            n: int(n == want) for n in routes}, (S, grad, needs)


# ------------------------------------------------------------- the LM
@pytest.fixture(scope="module")
def lm_params():
    """JAX's reduced LM parameters (numpy), REDUCED's init at key 0."""
    model = jax_get_arch(LM_ARCH).build_reduced()
    return jax.tree.map(np.asarray, model.init(jax.random.key(0)))


def port_lm(tree, cfg=REDUCED):
    model = TransformerLM(cfg, device="cpu", train=True)
    model.load_state_dict(convert.lm_params_from_numpy(tree, cfg,
                                                       torch.float32))
    return model


@pytest.fixture(scope="module")
def chunked_case(lm_params):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, REDUCED.vocab, (2, S_CHUNKED)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -5:] = -100                 # padding
    model = JaxTransformerLM(dataclasses.replace(JAX_REDUCED, q_chunk=16))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        lm_params, jnp.asarray(toks), jnp.asarray(labels))
    return toks, labels, float(loss), jax.tree.map(np.asarray, grads)


def test_lm_loss_and_grads_match_jax_through_mha_chunked(lm_params,
                                                        chunked_case):
    toks, labels, jloss, jgrads = chunked_case
    model = port_lm(lm_params, CHUNK_CFG)
    for p in model.parameters():
        assert p.dtype == torch.float32
    params = param_tree(model)
    n_chunked = []
    real = attention.mha_chunked
    with mock.patch.object(attention, "mha_chunked",
                           side_effect=lambda *a, **k: n_chunked.append(1)
                           or real(*a, **k)):
        loss, grads = value_and_grad(model, model.loss, params,
                                     torch.tensor(toks), torch.tensor(labels))
    # every layer's forward and its rematerialisation
    assert len(n_chunked) == 2 * CHUNK_CFG.n_layers
    assert_loss_close(loss, jloss)
    layout = convert.LMLayout(CHUNK_CFG)
    assert_grads_close(convert.params_to_numpy(grads, layout), jgrads,
                       "loss grad")
    # the loss alone, without grad, is the same function
    with torch.no_grad():
        assert_loss_close(model.loss(torch.tensor(toks),
                                     torch.tensor(labels)), jloss)


def test_lm_loss_without_remat_or_chunks_is_the_same(lm_params,
                                                    chunked_case):
    toks, labels, jloss, jgrads = chunked_case
    cfg = dataclasses.replace(CHUNK_CFG, remat=False, loss_chunks=1)
    model = port_lm(lm_params, cfg)
    loss, grads = value_and_grad(model, model.loss, param_tree(model),
                                 torch.tensor(toks), torch.tensor(labels))
    assert_loss_close(loss, jloss)
    assert_grads_close(convert.params_to_numpy(grads, convert.LMLayout(cfg)),
                       jgrads, "no-remat grad")


@pytest.fixture(scope="module")
def lm_step_runs(lm_params):
    """JAX's lm_step("train_4k") for N_STEPS steps per optimizer: the
    (loss, params, opt_state) after each step, numpy."""
    model = jax_get_arch(LM_ARCH).build_reduced()
    data = list(jax_token_batches(0, REDUCED.vocab, 256, LM_STEP_SEQ,
                                  N_STEPS))
    out = {}
    for opt_name in ("adam", "adam8bit"):
        step = jax.jit(jax_lm_step(model, "train_4k", grad_accum=LM_ACCUM,
                                   opt_name=opt_name))
        params = jax.tree.map(jnp.asarray, lm_params)
        state = jax_make_optimizer(opt_name).init(params)
        runs = []
        for toks, labels in data:
            params, state, loss = step(params, state, jnp.asarray(toks),
                                       jnp.asarray(labels))
            runs.append((float(loss), jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state)))
        out[opt_name] = runs
    return out


def _dequantized(state):
    """adam8bit's state in numpy JAX layout -> the moments in f32 and the
    raw codes."""
    def walk(node):
        if isinstance(node, dict) and set(node) == {"m", "v"} and \
                isinstance(node["m"], tuple):
            return {mv: np.asarray(_np(dequantize_blockwise(
                torch.tensor(node[mv][0]), torch.tensor(node[mv][1]))))
                for mv in ("m", "v")}
        return {k: walk(v) for k, v in node.items()}
    return walk(state["per_param"])


@pytest.mark.parametrize("opt_name", ["adam", "adam8bit"])
def test_lm_train_step_matches_jax(lm_params, lm_step_runs, opt_name):
    model = port_lm(lm_params)
    spec = get_arch(LM_ARCH)
    assert spec.optimizer == "adam"
    # the spec's step is lm_step at its default grad_accum, LM_ACCUM
    step = spec.step(model, "train_4k") if opt_name == "adam" else \
        lm_step(model, "train_4k", grad_accum=LM_ACCUM, opt_name=opt_name)
    params = param_tree(model)
    state = make_optimizer(opt_name).init(params)
    layout = convert.LMLayout(REDUCED)
    data = token_batches(0, REDUCED.vocab, 256, LM_STEP_SEQ, N_STEPS)
    for (toks, labels), (jloss, jparams, jstate) in zip(
            data, lm_step_runs[opt_name]):
        params, state, loss = step(params, state, torch.tensor(toks),
                                   torch.tensor(labels))
        assert_loss_close(loss, jloss)
        assert_trees_close(convert.params_to_numpy(params, layout), jparams,
                           STATE_TOL, "params")
        got = convert.opt_state_to_numpy(state, layout)
        assert int(got["t"]) == int(jstate["t"])
        if opt_name == "adam":
            assert_moments_close({"m": got["m"], "v": got["v"]},
                                 {"m": jstate["m"], "v": jstate["v"]},
                                 "adam moments")
        else:
            assert_trees_close(_dequantized(got), _dequantized(jstate),
                               STATE_TOL, "adam8bit moments")
            codes = [(g, w) for k, (g, w) in _pairs(got, jstate)]
            off = sum(int((np.abs(g.astype(int) - w) > 1).sum())
                      for g, w in codes)
            near = sum(int((g != w).sum()) for g, w in codes)
            total = sum(w.size for _, w in codes)
            assert off == 0 and near <= total // 1000, (off, near, total)
            assert_moments_close(_scales(got), _scales(jstate),
                                 "adam8bit block scales")


def _scales(state):
    """adam8bit's per-block scales of m and v, {path: array}."""
    return {k: v for k, v in _leaves(state["per_param"]).items()
            if k.endswith(".1")}


def _pairs(got, want):
    g, w = _leaves(got["per_param"]), _leaves(want["per_param"])
    return [(k, (g[k], w[k])) for k in w if k.endswith(".0")]


# ------------------------------------------- bf16 compute, f32 parameters
@pytest.fixture(scope="module")
def bf16_runs(lm_params, chunked_case):
    """JAX's reduced LM with bf16 compute over its f32 parameters, the
    dtype the published config trains in: the loss and its gradient on
    chunked_case's tokens (q_chunk 16), and lm_step("train_4k") for
    N_STEPS steps with adam on lm_step_runs' data."""
    toks, labels = chunked_case[:2]
    cfg = dataclasses.replace(JAX_REDUCED, dtype="bfloat16")
    model = JaxTransformerLM(dataclasses.replace(cfg, q_chunk=16))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        lm_params, jnp.asarray(toks), jnp.asarray(labels))
    step = jax.jit(jax_lm_step(JaxTransformerLM(cfg), "train_4k",
                               grad_accum=LM_ACCUM))
    params = jax.tree.map(jnp.asarray, lm_params)
    state = jax_make_optimizer("adam").init(params)
    runs = []
    for t, lab in jax_token_batches(0, REDUCED.vocab, 256, LM_STEP_SEQ,
                                    N_STEPS):
        params, state, jloss = step(params, state, jnp.asarray(t),
                                    jnp.asarray(lab))
        runs.append((float(jloss), jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, state)))
    return float(loss), jax.tree.map(np.asarray, grads), runs


def assert_within_reference_rounding(got, want, want_f32, what):
    """Per leaf, ||port - jax||_2 <= BF16_GAP x ||jax_f32 - jax||_2: the
    port's bf16 run lies within twice the distance that bf16 rounding
    puts between the reference's own f32 and bf16 runs."""
    g, w, f = _leaves(got), _leaves(want), _leaves(want_f32)
    assert g.keys() == w.keys() == f.keys(), what
    worst = 0.0
    for k in w:
        err = float(np.linalg.norm((g[k] - w[k]).ravel()))
        gap = float(np.linalg.norm((f[k] - w[k]).ravel()))
        assert err <= BF16_GAP * gap, \
            f"{what} {k}: ||port - jax|| {err} > {BF16_GAP} x {gap}"
        worst = max(worst, err / gap if gap else 0.0)
    print(f"{what}: worst leaf at {worst:.4f} of the reference's gap")


def test_lm_bf16_loss_and_grads_match_jax(lm_params, chunked_case,
                                          bf16_runs):
    """bf16 compute over f32 parameters through mha_chunked: the loss
    within bf16's unit roundoff of JAX's, each gradient leaf within
    twice the reference's own f32-to-bf16 distance."""
    toks, labels, _, jgrads_f32 = chunked_case
    jloss, jgrads, _ = bf16_runs
    cfg = dataclasses.replace(CHUNK_CFG, dtype="bfloat16")
    model = port_lm(lm_params, cfg)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    loss, grads = value_and_grad(model, model.loss, param_tree(model),
                                 torch.tensor(toks), torch.tensor(labels))
    assert abs(float(loss) - jloss) <= BF16_U * abs(jloss), (loss, jloss)
    assert_within_reference_rounding(
        convert.params_to_numpy(grads, convert.LMLayout(cfg)), jgrads,
        jgrads_f32, "bf16 grad")


def test_lm_bf16_train_steps_match_jax(lm_params, lm_step_runs, bf16_runs):
    """lm_step("train_4k") with bf16 compute for N_STEPS steps: each
    step's loss within bf16's unit roundoff of JAX's; parameters and
    Adam's moments per leaf within twice the reference's own f32-to-bf16
    distance (lm_step_runs is the f32 run from the same parameters and
    data)."""
    cfg = dataclasses.replace(REDUCED, dtype="bfloat16")
    model = port_lm(lm_params, cfg)
    step = lm_step(model, "train_4k", grad_accum=LM_ACCUM)
    params = param_tree(model)
    state = adam().init(params)
    layout = convert.LMLayout(cfg)
    data = token_batches(0, REDUCED.vocab, 256, LM_STEP_SEQ, N_STEPS)
    for (toks, labels), (jloss, jparams, jstate), (_, fparams, fstate) in \
            zip(data, bf16_runs[2], lm_step_runs["adam"]):
        params, state, loss = step(params, state, torch.tensor(toks),
                                   torch.tensor(labels))
        assert abs(float(loss) - jloss) <= BF16_U * abs(jloss), (loss, jloss)
        assert_within_reference_rounding(
            convert.params_to_numpy(params, layout), jparams, fparams,
            "bf16 params")
        got = convert.opt_state_to_numpy(state, layout)
        assert int(got["t"]) == int(jstate["t"])
        assert_within_reference_rounding(
            {"m": got["m"], "v": got["v"]},
            {"m": jstate["m"], "v": jstate["v"]},
            {"m": fstate["m"], "v": fstate["v"]}, "bf16 moments")


def test_opt_state_carries_both_ways(lm_params, lm_step_runs):
    """JAX's state after a step -> the port -> back is JAX's state, for
    both optimizers; a port step from JAX's converted state continues
    JAX's run."""
    layout = convert.LMLayout(REDUCED)
    for opt_name, runs in lm_step_runs.items():
        _, jparams, jstate = runs[0]
        state = convert.opt_state_from_numpy(jstate, layout)
        back = convert.opt_state_to_numpy(state, layout)
        assert_trees_close(back, jstate, 0.0, f"{opt_name} round trip")
        assert state["t"].dtype == torch.int32
    _, jparams, jstate = lm_step_runs["adam"][0]
    jloss1, jparams1, _ = lm_step_runs["adam"][1]
    model = port_lm(jparams)
    params = param_tree(model)
    state = convert.opt_state_from_numpy(jstate, layout)
    toks, labels = list(token_batches(0, REDUCED.vocab, 256, LM_STEP_SEQ,
                                      2))[1]
    params, state, loss = lm_step(model, "train_4k", grad_accum=LM_ACCUM)(
        params, state, torch.tensor(toks), torch.tensor(labels))
    assert_loss_close(loss, jloss1)
    assert_trees_close(convert.params_to_numpy(params, layout), jparams1,
                       STATE_TOL, "continued params")


def test_lm_step_k_rule_matches_jax():
    """k = grad_accum when it divides the shape's batch, else 1; the
    train_step reshapes its tokens [k, B / k, S]."""
    model = TransformerLM(REDUCED, device="cpu", train=True)
    params = param_tree(model)
    toks = torch.zeros(256, 4, dtype=torch.int64)
    for accum, want_mb in ((8, 32), (3, 256), (256, 1)):
        seen = []
        with mock.patch.object(model, "loss", side_effect=lambda t, l:
                               seen.append(t.shape[0]) or
                               (model.lm_head * 0).sum()):
            lm_step(model, "train_4k", grad_accum=accum)(
                params, adam().init(params), toks, toks)
        assert set(seen) == {want_mb} and len(seen) == 256 // want_mb


# -------------------------------------------------------- the two-tower
@pytest.fixture(scope="module")
def tt_case():
    model = jax_get_arch(TT_ARCH).build_reduced()
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    c = tt_cfg.REDUCED
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(N_STEPS):
        u = rng.integers(-1, c.user_vocab, (TT_BATCH, c.user_fields,
                                            c.max_ids_per_field))
        i = rng.integers(-1, c.item_vocab, (TT_BATCH, c.item_fields,
                                            c.max_ids_per_field))
        batches.append({"user_ids": u.astype(np.int32),
                        "item_ids": i.astype(np.int32),
                        "item_logq": rng.normal(size=TT_BATCH)
                        .astype(np.float32) - 4.0})
    b = {k: jnp.asarray(v) for k, v in batches[0].items()}
    vg = jax.jit(jax.value_and_grad(model.loss))
    losses = {logq: vg(params, b["user_ids"], b["item_ids"],
                       b["item_logq"] if logq else None)
              for logq in (True, False)}
    step = jax.jit(jax_tt_cfg.step(model, "train_batch"))
    from repro.optim import adam as jax_adam
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_adam().init(jp)
    runs = []
    for batch in batches:
        jp, js, loss = step(jp, js, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        runs.append((float(loss), jax.tree.map(np.asarray, jp),
                     jax.tree.map(np.asarray, js)))
    return params, batches, {k: (float(l), jax.tree.map(np.asarray, g))
                             for k, (l, g) in losses.items()}, runs


def port_tt(tree):
    model = TwoTower(tt_cfg.REDUCED, device="cpu", seed=1)
    model.load_state_dict(convert.two_tower_params_from_numpy(tree))
    return model


@pytest.mark.parametrize("logq", [True, False])
@pytest.mark.parametrize("scores", [None, 640])
def test_two_tower_loss_and_grads_match_jax(tt_case, logq, scores):
    """scores 640: blocks of 10 rows (7 blocks, the last of 4), so the
    row-blocked, checkpointed logits run as at full width."""
    params, batches, losses, _ = tt_case
    jloss, jgrads = losses[logq]
    model = port_tt(params)
    b = {k: torch.tensor(v) for k, v in batches[0].items()}
    with mock.patch.object(two_tower, "LOSS_SCORES",
                           scores or two_tower.LOSS_SCORES):
        loss, grads = value_and_grad(
            model, model.loss, param_tree(model), b["user_ids"],
            b["item_ids"], b["item_logq"] if logq else None)
    assert_loss_close(loss, jloss)
    assert_grads_close(convert.params_to_numpy(grads,
                                               convert.TwoTowerLayout()),
                       jgrads, "two-tower grad")


def test_two_tower_train_steps_match_jax(tt_case):
    params, batches, _, runs = tt_case
    model = port_tt(params)
    step = get_arch(TT_ARCH).step(model, "train_batch")
    p = param_tree(model)
    state = adam().init(p)
    layout = convert.TwoTowerLayout()
    for batch, (jloss, jparams, jstate) in zip(batches, runs):
        p, state, loss = step(p, state, {k: torch.tensor(v)
                                         for k, v in batch.items()})
        assert_loss_close(loss, jloss)
        assert_trees_close(convert.params_to_numpy(p, layout), jparams,
                           STATE_TOL, "params")
        got = convert.opt_state_to_numpy(state, layout)
        assert int(got["t"]) == int(jstate["t"])
        assert_moments_close({"m": got["m"], "v": got["v"]},
                             {"m": jstate["m"], "v": jstate["v"]},
                             "moments")


def test_two_tower_train_build_cuts_both_tables(monkeypatch):
    made = []
    monkeypatch.setattr(tt_cfg, "TwoTower",
                        lambda cfg, device, seed: made.append(cfg))
    spec = get_arch(TT_ARCH)
    spec.build(device="cpu", train=True)
    spec.build(device="cpu")
    (train, serve) = made
    assert (train.user_vocab, train.item_vocab) == (
        tt_cfg.TRAIN_USER_VOCAB, tt_cfg.TRAIN_ITEM_VOCAB) == (5_000_192,
                                                              500_224)
    assert train.user_vocab % 512 == 0 and train.item_vocab % 512 == 0
    assert dataclasses.replace(train, user_vocab=0, item_vocab=0) == \
        dataclasses.replace(tt_cfg.CONFIG, user_vocab=0, item_vocab=0)
    assert serve.user_vocab == tt_cfg.ONE_CARD_USER_VOCAB
    assert serve.item_vocab == tt_cfg.CONFIG.item_vocab


# ------------------------------------------------- embedding-bag backward
def _bag_case(seed, B=40, W=5, V=30, d=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, V, (B, W))
    ids[:4] = -1                           # empty bags
    ids[4, 1:] = -1
    table = rng.normal(size=(V, d)).astype(np.float32)
    w = rng.normal(size=(B, d)).astype(np.float32)
    return table, ids, w


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embedding_bag_backward_matches_autograd_and_jax(mode, id_dtype):
    table, ids, w = _bag_case(3)
    t_ids = torch.tensor(ids, dtype=id_dtype)
    leaf = torch.tensor(table, requires_grad=True)
    out = eb_ops.embedding_bag(leaf, t_ids, mode)
    (got,) = torch.autograd.grad((out * torch.tensor(w)).sum(), leaf)
    plain = torch.tensor(table, requires_grad=True)
    (want,) = torch.autograd.grad(
        (eb_ref.embedding_bag_ref(plain, t_ids, mode)
         * torch.tensor(w)).sum(), plain)
    tol = lambda ref: 1e-6 * (1 + np.abs(ref))
    assert (np.abs(_np(got) - _np(want)) <= tol(_np(want))).all()
    jgrad = jax.grad(lambda t: jnp.sum(jax_bag(t, jnp.asarray(ids), mode)
                                       * jnp.asarray(w)))(
        jnp.asarray(table))
    assert (np.abs(_np(got) - np.asarray(jgrad))
            <= tol(np.asarray(jgrad))).all()
    # the plain version of the backward, called directly
    direct = eb_ops.embedding_bag_grad(torch.tensor(w), t_ids, table.shape[0],
                                       mode)
    np.testing.assert_array_equal(_np(direct), _np(got))
    # rows no id names read 0; the forward is the plain one
    unused = np.setdiff1d(np.arange(table.shape[0]), ids[ids >= 0])
    assert (_np(got)[unused] == 0).all()
    torch.testing.assert_close(out.detach(), eb_ref.embedding_bag_ref(
        torch.tensor(table), t_ids, mode), rtol=0, atol=0)


def test_embedding_bag_backward_drops_ids_past_the_table():
    table, ids, w = _bag_case(4)
    ids[6, 0] = table.shape[0] + 3        # a NaN bag forward; no grad row
    leaf = torch.tensor(table, requires_grad=True)
    out = eb_ops.embedding_bag(leaf, torch.tensor(ids), "mean")
    assert bool(out[6].isnan().all())
    g = torch.zeros_like(out)
    g[:6] = torch.tensor(w[:6])
    (got,) = torch.autograd.grad(out, leaf, g)
    want = eb_ref.embedding_bag_grad_ref(g, torch.tensor(ids), table.shape[0])
    np.testing.assert_array_equal(_np(got), _np(want))
    assert got.isfinite().all()


def test_embedding_bag_grad_under_torch_func_and_without_grad():
    table, ids, w = _bag_case(5)
    t_ids = torch.tensor(ids)
    fn = lambda t: (eb_ops.embedding_bag(t, t_ids, "mean")
                    * torch.tensor(w)).sum()
    with mock.patch.object(eb_ops, "embedding_bag_grad",
                           wraps=eb_ops.embedding_bag_grad) as backward:
        got = torch.func.grad(fn)(torch.tensor(table))
    assert backward.call_count == 1          # through the autograd.Function
    want = eb_ref.embedding_bag_grad_ref(torch.tensor(w), t_ids,
                                         table.shape[0])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    leaf = torch.tensor(table, requires_grad=True)
    with torch.no_grad():
        assert not eb_ops.embedding_bag(leaf, t_ids).requires_grad
    # no gradient flows to the ids (integers), and the serve path (a
    # table that requires none) takes no graph
    assert not eb_ops.embedding_bag(torch.tensor(table), t_ids).requires_grad


def test_refuse_grad_raises_only_under_grad_for_a_tensor_requiring_it():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_lib.refuse_grad("deliver_rows", None, x)
    with torch.no_grad():
        cuda_lib.refuse_grad("deliver_rows", x)
    cuda_lib.refuse_grad("deliver_rows", torch.zeros(3), None)


# ------------------------------------------------------ configs, binding
def test_make_optimizer_and_arch_optimizer_field():
    from repro_torch.optim.quantized import QState
    assert [f.name for f in dataclasses.fields(ArchSpec)][-1] == "optimizer"
    p = {"w": torch.zeros(4, 256)}
    assert set(make_optimizer("adam").init(p)) == {"m", "v", "t"}
    s8 = make_optimizer("adam8bit").init(p)
    assert isinstance(s8["per_param"]["w"]["m"], QState)
    assert get_arch(TT_ARCH).optimizer == "adam"


def test_bound_params_restores_the_module():
    model = TransformerLM(REDUCED, device="cpu", train=True)
    own = model.lm_head
    other = torch.zeros_like(own)
    with bound_params(model, {"lm_head": other}):
        assert model.lm_head is other
    assert model.lm_head is own
    with pytest.raises(KeyError, match="not a parameter"):
        with bound_params(model, {"blocks.0.nope": other}):
            pass
    assert model.lm_head is own


def test_serve_model_keeps_cfg_dtype_and_train_model_f32():
    cfg = dataclasses.replace(REDUCED, dtype="bfloat16")
    serve_model = TransformerLM(cfg, device="cpu", seed=3)
    train_model = TransformerLM(cfg, device="cpu", seed=3, train=True)
    for (n, a), (_, b) in zip(serve_model.named_parameters(),
                              train_model.named_parameters()):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.float32, n
        torch.testing.assert_close(a, b.to(torch.bfloat16), rtol=0, atol=0)


# ------------------------------------------------------------ launcher
STEP_LINE = re.compile(r"step (\d+): loss=(\d+\.\d{4}) \((\d+\.\d\d)s\)")


def _lines(out):
    lines = out.strip().splitlines()
    steps = [STEP_LINE.fullmatch(line) for line in lines[:-1]]
    assert all(steps) and lines[-1] == "train driver done", lines
    return [float(m.group(2)) for m in steps], \
        [int(m.group(1)) for m in steps]


@pytest.mark.parametrize("arch,shape", [(LM_ARCH, "train_4k"),
                                        (TT_ARCH, "train_batch")])
def test_train_cli_reduced_cpu_matches_jax_launcher(arch, shape, capsys,
                                                    monkeypatch):
    from repro.launch import train as jax_train
    argv = ["--arch", arch, "--shape", shape, "--reduced", "--steps", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train.main()
    want, want_idx = _lines(capsys.readouterr().out)
    tree = jax.tree.map(np.asarray, jax_get_arch(arch).build_reduced()
                        .init(jax.random.key(0)))
    spec = get_arch(arch)

    def build_reduced(device=None, seed=0, train=False):
        return port_lm(tree) if arch == LM_ARCH else port_tt(tree)

    monkeypatch.setattr("repro_torch.configs.get_arch",
                        lambda a: dataclasses.replace(
                            spec, build_reduced=build_reduced))
    model, params, state, losses = train_cli.main(argv + ["--device",
                                                          "cpu"])
    got, got_idx = _lines(capsys.readouterr().out)
    assert got_idx == want_idx == [0, 1, 2]
    for g, w, full in zip(got, want, losses):
        assert abs(full - w) <= 1e-4 * abs(w) + 5e-5, (got, want)
    assert int(state["t"]) == 3
    for n, p in model.named_parameters():    # the model holds the result
        assert p is not params[n] and p.data_ptr() == params[n].data_ptr()


def test_train_cli_trains_with_the_spec_optimizer(monkeypatch):
    """The launcher builds `make_optimizer(spec.optimizer)` and steps
    through `spec.step` at grad_accum 1: with the spec's optimizer set to
    adam8bit, one launcher step equals lm_step's adam8bit step on the
    same parameters and tokens."""
    spec = get_arch(LM_ARCH)
    monkeypatch.setattr("repro_torch.configs.get_arch",
                        lambda a: dataclasses.replace(spec,
                                                      optimizer="adam8bit"))
    model, params, state, losses = train_cli.main(
        ["--arch", LM_ARCH, "--shape", "train_4k", "--reduced", "--steps",
         "1", "--device", "cpu"])
    ref = spec.build_reduced(device="cpu", seed=0, train=True)
    p = param_tree(ref)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, REDUCED.vocab, (2, 64)))
    p, want_state, loss = lm_step(ref, "train_4k", grad_accum=1,
                                  opt_name="adam8bit")(
        p, make_optimizer("adam8bit").init(p), toks, torch.roll(toks, -1, 1))
    assert "per_param" in state and losses == [float(loss)]
    for n in p:
        torch.testing.assert_close(params[n], p[n], rtol=0, atol=0)


def test_train_cli_refuses_a_shape_that_is_not_a_train_shape(tmp_path):
    with pytest.raises(ValueError, match="not a train shape"):
        train_cli.main(["--arch", "d3gnn-sage", "--shape", "stream_tick",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="not a train shape"):
        train_cli.main(["--arch", LM_ARCH, "--shape", "prefill_32k",
                        "--reduced", "--device", "cpu"])
    model, params, state, losses = train_cli.main(
        ["--arch", TT_ARCH, "--shape", "train_batch", "--reduced", "--steps",
         "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == [
        "0000000000.ckpt", "0000000001.ckpt"]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_reference_two_tower_grad_is_nan_for_a_user_without_ids(tt_case):
    """A user whose every field is padding has a zero embedding; at the
    init's zero biases its tower output is exactly 0, and JAX's
    l2_normalize differentiates ||x|| at 0 to NaN (0/0), which its train
    step spreads into every parameter. torch's vector_norm takes the zero
    subgradient there, so the port's gradient stays finite (and so its
    step). A reference fault, kept in the JAX package (ROADMAP Queue 3)."""
    params, batches, _, _ = tt_case
    b = dict(batches[0])
    b["user_ids"] = b["user_ids"].copy()
    b["user_ids"][0] = -1
    model = jax_get_arch(TT_ARCH).build_reduced()
    jgrads = jax.grad(model.loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(b["user_ids"]),
        jnp.asarray(b["item_ids"]), jnp.asarray(b["item_logq"]))
    assert np.isnan(np.asarray(jgrads["user_mlp"]["l1"]["b"])).any()
    port = port_tt(params)
    loss, grads = value_and_grad(port, port.loss, param_tree(port),
                                 *(torch.tensor(b[k]) for k in (
                                     "user_ids", "item_ids", "item_logq")))
    assert bool(loss.isfinite()) and all(bool(g.isfinite().all())
                                         for g in grads.values())
