"""The LM train step at the published width: one layer of mistral-nemo-12b
(d_model 5120, 32 heads over 8 kv heads, head_dim 128) with d_ff cut to
1024 and the vocab to 1024, bf16 compute over f32 parameters, trained
for three steps on token_batches (4 x 128 Zipf tokens a step) by JAX's
recipe (its launcher's LM branch: value_and_grad, clip_by_global_norm(1.0),
Adam at 3e-4) and by the port's lm_step("train_4k") at grad_accum 1, from
the same JAX init.

Each step's loss (the one before its update) lies within 2^-8 (bf16's
unit roundoff) of JAX's. At this width Adam's first step, about
lr * sign(g) on every weight, moves a 5,120-wide row's output by about
lr * sum |x_i| ~ 1, as much as the outputs themselves, so the next
batch's loss RISES, by more than 1 nat: JAX's recipe does this, and the
port must do it alike. This is the witness that the rise seen in the
full-width train run is the recipe's and not the port's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs.mistral_nemo_12b import CONFIG as JAX_CONFIG
from repro.data.streams import token_batches
from repro.nn.transformer import TransformerLM as JaxTransformerLM
from repro.optim import adam as jax_adam
from repro.optim import apply_updates, clip_by_global_norm
from repro_torch import convert
from repro_torch.configs.base import lm_step
from repro_torch.configs.mistral_nemo_12b import CONFIG
from repro_torch.nn.module import param_tree
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import adam

CUT = dict(n_layers=1, d_ff=1024, vocab=1024)
BATCH, SEQ, STEPS = 4, 128, 3
BF16_U = 2.0 ** -8


def test_one_layer_at_width_5120_trains_as_jax_and_rises_alike():
    jcfg = dataclasses.replace(JAX_CONFIG, **CUT)
    cfg = dataclasses.replace(CONFIG, **CUT)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.dtype) \
        == (5120, 32, 8, 128, "bfloat16")
    data = list(token_batches(0, cfg.vocab, BATCH, SEQ, STEPS))

    jmodel = JaxTransformerLM(jcfg)
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    value_and_grad = jax.jit(jax.value_and_grad(jmodel.loss))
    opt = jax_adam()
    params = jax.tree.map(jnp.asarray, init)
    state = opt.init(params)
    want = []
    for toks, labels in data:
        loss, grads = value_and_grad(params, jnp.asarray(toks),
                                     jnp.asarray(labels))
        grads, _ = clip_by_global_norm(grads, 1.0)
        upd, state = opt.update(state, grads, params, 3e-4)
        params = apply_updates(params, upd)
        want.append(float(loss))
    del params, state, grads, upd

    model = TransformerLM(cfg, device="cpu", train=True)
    model.load_state_dict(convert.lm_params_from_numpy(init, cfg,
                                                       torch.float32))
    del init
    step = lm_step(model, "train_4k", grad_accum=1)
    p = param_tree(model)
    s = adam().init(p)
    got = []
    for toks, labels in data:
        p, s, loss = step(p, s, torch.tensor(toks), torch.tensor(labels))
        got.append(float(loss))

    print(f"losses by step: JAX {want}, port {got}")
    for g, w in zip(got, want):
        assert abs(g - w) <= BF16_U * abs(w), (got, want)
    assert want[1] > want[0] + 1 and got[1] > got[0] + 1, (got, want)
