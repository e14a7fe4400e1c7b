"""The port's optimizers, schedules and gradient compression against the
JAX package's, on the CPU.

The same numpy parameter and gradient trees, made from a seed, go through
both: every optimizer for 10 steps (plain, and per part over a leading
[P] axis against JAX's vmap, the training plane's Algorithm 3 use) and
every schedule over 10 steps, within rtol 1e-6. Compression: the
conservation invariant and the dtype carry of
tests/test_grad_compression.py (:26, :52), the reconstruction against
JAX's within 1e-6 (inputs drawn from a normal distribution, so no two
magnitudes tie at the top-k threshold), and the per-part (batched) form
against JAX's vmap.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jopt
from repro.dist import grad_compression as jgc
from repro.optim import quantized as jq
from repro_torch import optim as topt
from repro_torch.dist import grad_compression as tgc
from repro_torch.optim import quantized as tq
from repro_torch.optim.optimizers import init_stacked, tree_leaves, tree_map

RTOL = 1e-6


def _tree(rng, P=None):
    lead = () if P is None else (P,)
    return {"self": {"w": rng.normal(size=lead + (6, 256)).astype(np.float32),
                     "b": rng.normal(size=lead + (256,)).astype(np.float32)},
            "neigh": {"w": rng.normal(size=lead + (6, 5)).astype(np.float32)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-7)


OPTS = {"sgd": lambda m: m.sgd(),
        "sgd_momentum": lambda m: m.sgd(momentum=0.9),
        "sgd_nesterov": lambda m: m.sgd(momentum=0.9, nesterov=True),
        "adam": lambda m: m.adam(),
        "adam_wd": lambda m: m.adam(weight_decay=1e-2),
        "adamax": lambda m: m.adamax()}


@pytest.mark.parametrize("name", list(OPTS) + ["adam8bit"])
def test_optimizer_ten_steps_match_jax(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    if name == "adam8bit":
        jo, to = jq.adam8bit(), tq.adam8bit()
    else:
        jo, to = OPTS[name](jopt), OPTS[name](topt)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(10):
        g = _tree(rng)
        ju, js = jo.update(js, _j(g), jp, 1e-2)
        tu, ts = to.update(ts, _t(g), tp, 1e-2)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _close(tu, ju)
    _close(tp, jp)


@pytest.mark.parametrize("name", ["sgd_momentum", "adam", "adamax"])
def test_per_part_optimizer_matches_jax_vmap(name):
    """One optimizer per part over a leading [P] axis, as the training
    plane's Algorithm 3 runs it: the port's stacked state and broadcast
    update against JAX's vmap of init and update."""
    P = 3
    rng = np.random.default_rng(1)
    base = _tree(rng)
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(p, (P,) + p.shape),
                           _j(base))
    js = jax.vmap(jo.init)(stacked)
    ts = init_stacked(to, _t(base), P)
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
        assert tuple(a.shape) == b.shape
    tstack = tree_map(lambda p: p.expand((P,) + tuple(p.shape)), _t(base))
    for _ in range(10):
        g = _tree(rng, P)
        ju, js = jax.vmap(lambda p, gg, s: jo.update(s, gg, p, 1e-2))(
            stacked, _j(g), js)
        tu, ts = to.update(ts, _t(g), tstack, 1e-2)
        _close(tu, ju)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    g = _tree(rng)
    jg, jn = jopt.clip_by_global_norm(_j(g), 1.0)
    tg, tn = topt.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tg, jg)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)), ("cosine_decay", (0.1, 7)),
    ("warmup_cosine", (0.1, 3, 9)), ("warmup_cosine", (0.1, 0, 5))])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(10):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tf(torch.tensor(step))),
                                   float(jf(jnp.asarray(step))), rtol=RTOL)


def test_blockwise_quantizer_matches_jax():
    rng = np.random.default_rng(3)
    for shape in ((4, 512), (3, 7), (256,)):
        x = rng.normal(size=shape).astype(np.float32)
        jq_, js_ = jq.quantize_blockwise(jnp.asarray(x))
        tq_, ts_ = tq.quantize_blockwise(torch.from_numpy(x))
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=RTOL)
        np.testing.assert_allclose(
            tq.dequantize_blockwise(tq_, ts_).numpy(),
            np.asarray(jq.dequantize_blockwise(jq_, js_)), rtol=RTOL)


# ------------------------------------------------------------ compression

def _grads(rng, dtype=torch.float32):
    return {"w": torch.tensor(rng.normal(size=(32, 16))).to(dtype),
            "b": torch.tensor(rng.normal(size=(16,))).to(dtype)}


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32-wire"])
def test_compression_conservation_and_jax_parity(int8):
    """sent + new_res == g + res exactly per step, the telescoped sum
    tracks the true sum, and each step's result equals JAX's."""
    rng = np.random.default_rng(0)
    res = tgc.init_error_feedback(_grads(rng))
    jres = jax.tree.map(lambda x: jnp.asarray(x.numpy()), res)
    total_sent = tree_map(torch.zeros_like, res)
    total_true = tree_map(torch.zeros_like, res)
    for _ in range(8):
        g = _grads(rng)
        sent, new_res = tgc.compress_decompress(g, res, int8=int8,
                                                topk_frac=0.25)
        jsent, jres = jgc.compress_decompress(
            jax.tree.map(lambda x: jnp.asarray(x.numpy()), g), jres,
            int8=int8, topk_frac=0.25)
        _close(sent, jsent)
        _close(new_res, jres)
        for k in g:
            assert torch.equal(sent[k] + new_res[k], g[k] + res[k])
        total_sent = tree_map(torch.add, total_sent, sent)
        total_true = tree_map(torch.add, total_true, g)
        res = new_res
    for k in res:
        np.testing.assert_allclose((total_sent[k] + res[k]).numpy(),
                                   total_true[k].numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32],
                         ids=["bf16", "f16", "f32"])
def test_compression_fixed_dtype_carry(dtype):
    rng = np.random.default_rng(1)
    g = _grads(rng, dtype)
    res = tree_map(lambda x: torch.zeros(x.shape), g)
    sent, new_res = tgc.compress_decompress(g, res, int8=True,
                                            topk_frac=0.25)
    for k in g:
        assert sent[k].dtype == dtype and new_res[k].dtype == torch.float32
    sent, new_res = tgc.compress_decompress(
        g, tree_map(torch.zeros_like, g), int8=True)
    for k in g:
        assert sent[k].dtype == dtype and new_res[k].dtype == dtype


def test_batched_compression_matches_jax_vmap():
    """Per-part compression (a leading [P] axis) against JAX's vmap."""
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(4, 8, 8)).astype(np.float32)}
    res = {"w": rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.1}
    js, jr = jax.vmap(lambda gg, rr: jgc.compress_decompress(
        gg, rr, int8=True, topk_frac=0.25))(_j(g), _j(res))
    ts, tr = tgc.compress_decompress(_t(g), _t(res), int8=True,
                                     topk_frac=0.25, batched=True)
    _close(ts, js)
    _close(tr, jr)
