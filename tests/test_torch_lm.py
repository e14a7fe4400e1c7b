"""The port's LM serve path (repro_torch.nn.{rotary,layers,attention,
transformer}, configs, convert, launch.serve) against the JAX package on
the CPU, on mistral-nemo-12b's REDUCED config (f32, 4 layers, head_dim 16)
with the parameters of JAX's `TransformerLM.init` carried over by
`convert.lm_params_from_numpy`.

Tolerances (f32): 1e-5 for RoPE and the layers; 1e-4 for hidden states,
logits and the prefill step at S = 512, where JAX runs its chunked
attention (q_chunk 256) and the port the flash kernel's plain version;
2e-4 for decode logits, the bound of tests/test_models_smoke.py:68. Greedy
tokens are equal.

The JAX model compiles slowly on the CPU, so each JAX result is computed
once per module (module-scoped fixtures).
"""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import lm_input_specs as jax_lm_input_specs
from repro.configs.base import lm_step as jax_lm_step
from repro.nn import layers as jlayers
from repro.nn.module import param_count as jax_param_count
from repro.nn.rotary import apply_rope as jax_apply_rope
from repro_torch.configs import get_arch
from repro_torch.configs.base import LM_SHAPES
from repro_torch.configs.mistral_nemo_12b import CONFIG, REDUCED
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.nn import layers
from repro_torch.nn.module import param_bytes, param_count
from repro_torch.nn.rotary import apply_rope
from repro_torch.nn.transformer import TransformerLM

ARCH = "mistral-nemo-12b"
S_PREFILL, B = 512, 2
N_DECODE, B_DECODE = 8, 4


@pytest.fixture(scope="module")
def jax_lm():
    model = jax_get_arch(ARCH).build_reduced()
    params = model.init(jax.random.key(0))
    return model, params


@pytest.fixture(scope="module")
def port_lm(jax_lm):
    _, params = jax_lm
    tree = jax.tree.map(np.asarray, params)
    model = TransformerLM(REDUCED, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tree, REDUCED))
    return model


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, REDUCED.vocab,
                                             (B, S_PREFILL))


@pytest.fixture(scope="module")
def jax_forward(jax_lm, tokens):
    model, params = jax_lm
    toks = jnp.asarray(tokens, jnp.int32)
    hidden = jax.jit(lambda p, t: model.hidden_states(p, t)[0])(params, toks)
    logits = jax.jit(model.logits)(params, toks)
    prefill = jax.jit(jax_lm_step(model, "prefill_32k"))(params, toks)
    return np.asarray(hidden), np.asarray(logits), np.asarray(prefill)


@pytest.fixture(scope="module")
def jax_greedy(jax_lm):
    """N_DECODE greedy steps from random prompts, as serve_lm runs them."""
    model, params = jax_lm
    cache = model.init_cache(B_DECODE, N_DECODE + 8)
    tok = jnp.asarray(np.random.default_rng(1).integers(
        0, REDUCED.vocab, (B_DECODE, 1)), jnp.int32)
    decode = jax.jit(model.decode_step)
    toks, logits = [], []
    for _ in range(N_DECODE):
        lg, cache = decode(params, cache, tok)
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits.append(np.asarray(lg))
    return np.concatenate(toks, 1), np.stack(logits)


def _t(a):
    return torch.as_tensor(np.array(a))


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 40000, (2, 24))
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta)
    got = apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=64).astype(np.float32)
    want = jlayers.RMSNorm(64)({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    norm = layers.RMSNorm(64, device="cpu")
    norm.scale.copy_(_t(scale))
    np.testing.assert_allclose(norm(_t(x)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_swiglu_matches_jax():
    mod = jlayers.SwiGLU(64, 160)
    params = mod.init(jax.random.key(4))
    x = np.random.default_rng(4).normal(size=(2, 7, 64)).astype(np.float32)
    ffn = layers.SwiGLU(64, 160, device="cpu")
    ffn.load_state_dict({k: _t(v) for k, v in params.items()})
    np.testing.assert_allclose(ffn(_t(x)).numpy(),
                               np.asarray(mod(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_embedding_takes_in_table_dtype():
    emb = layers.Embedding(10, 4, dtype=torch.bfloat16, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    out = emb(torch.tensor([[1, 9]]))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 4)
    assert torch.equal(out[0, 1], emb.table[9])


@pytest.mark.parametrize("S,T,q_offset", [(9, 9, 0), (3, 11, 8)])
def test_mha_matches_jax(S, T, q_offset):
    """The reference attention with a causal mask (offset queries: the last
    S of T positions), GQA 4 heads over 2."""
    from repro.nn.attention import causal_mask as jax_causal_mask
    from repro.nn.attention import mha as jax_mha
    from repro_torch.nn.attention import causal_mask, mha
    rng = np.random.default_rng(S + T)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    mask = causal_mask(S, T, q_offset)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jax_causal_mask(S, T, q_offset)))
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   mask=jax_causal_mask(S, T, q_offset))
    np.testing.assert_allclose(mha(_t(q), _t(k), _t(v), mask=mask).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_shards,masked_shard", [(4, None), (4, 2),
                                                    (2, None)])
def test_decode_partial_combine_matches_full(n_shards, masked_shard):
    """The sequence-sharded decode (test_system.py's case): partial
    attention a shard, combined by log-sum-exp, equals the full decode
    within 1e-5, and each shard's partials equal JAX's; a shard whose
    rows are all masked contributes nothing."""
    from repro.nn.attention import combine_partial_decodes as jax_combine
    from repro.nn.attention import decode_attend as jax_decode
    from repro.nn.attention import decode_attend_partial as jax_partial
    from repro_torch.nn.attention import (combine_partial_decodes,
                                          decode_attend,
                                          decode_attend_partial)
    rng = np.random.default_rng(0)
    B, T, Kh, G, D = 2, 64, 2, 3, 16
    H = Kh * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Kh, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Kh, D)).astype(np.float32)
    valid = rng.random((B, T)) > 0.1
    n = T // n_shards
    if masked_shard is not None:
        valid[:, masked_shard * n:(masked_shard + 1) * n] = False
    full = decode_attend(_t(q), _t(k), _t(v), torch.as_tensor(valid))
    parts, jparts = [], []
    for i in range(n_shards):
        sl = slice(i * n, (i + 1) * n)
        parts.append(decode_attend_partial(_t(q), _t(k[:, sl]),
                                           _t(v[:, sl]),
                                           torch.as_tensor(valid[:, sl])))
        jparts.append(jax_partial(jnp.asarray(q), jnp.asarray(k[:, sl]),
                                  jnp.asarray(v[:, sl]),
                                  jnp.asarray(valid[:, sl])))
        for got, want in zip(parts[-1], jparts[-1]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    comb = combine_partial_decodes(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(comb.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    jcomb = jax_combine(*(jnp.stack(x) for x in zip(*jparts)))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v),
                                            jnp.asarray(valid))),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- model
def test_param_count_matches_jax(jax_lm, port_lm):
    assert param_count(port_lm) == jax_param_count(jax_lm[1])
    assert param_bytes(port_lm) == 4 * param_count(port_lm)     # f32


def test_hidden_states_match_jax(port_lm, tokens, jax_forward):
    got = port_lm.hidden_states(_t(tokens))
    np.testing.assert_allclose(got.numpy(), jax_forward[0], rtol=1e-4,
                               atol=1e-4)


def test_logits_match_jax(port_lm, tokens, jax_forward):
    got = port_lm.logits(_t(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_forward[1], rtol=1e-4,
                               atol=1e-4)


def test_prefill_step_matches_jax(port_lm, tokens, jax_forward):
    got = get_arch(ARCH).step(port_lm, "prefill_32k")(_t(tokens))
    assert got.shape == (B, REDUCED.vocab)
    np.testing.assert_allclose(got.numpy(), jax_forward[2], rtol=1e-4,
                               atol=1e-4)


def test_greedy_decode_matches_jax(port_lm, jax_greedy):
    want_toks, want_logits = jax_greedy
    cache = port_lm.init_cache(B_DECODE, N_DECODE + 8)
    tok = _t(np.random.default_rng(1).integers(0, REDUCED.vocab,
                                               (B_DECODE, 1)))
    step = get_arch(ARCH).step(port_lm, "decode_32k")
    k, v, length = cache["k"], cache["v"], cache["len"]
    toks, logits = [], []
    for pos in range(N_DECODE):
        lg, k, v, length = step(tok, k, v, length, pos)
        tok = torch.argmax(lg[:, -1:], dim=-1)
        toks.append(tok.numpy())
        logits.append(lg.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, 1), want_toks)
    np.testing.assert_allclose(np.stack(logits), want_logits, rtol=2e-4,
                               atol=2e-4)
    assert length.tolist() == [N_DECODE] * B_DECODE


def test_decode_matches_forward(port_lm, tokens):
    """Decode logits, one token at a time, equal the forward's slice."""
    S = 12
    toks = _t(tokens[:, :S])
    full = port_lm.logits(toks)
    cache = port_lm.init_cache(B, S + 4)
    outs = []
    for t in range(S):
        lg, cache = port_lm.decode_step(cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_decode_past_the_cache_end_raises_naming_max_len(port_lm):
    """A full cache is refused on the host position before any write: the
    cache's k/v are left as they were."""
    T = 3
    cache = port_lm.init_cache(B_DECODE, T)
    tok = _t(np.zeros((B_DECODE, 1), np.int64))
    for _ in range(T):
        _, cache = port_lm.decode_step(cache, tok)
    assert cache["pos"] == T and cache["len"].tolist() == [T] * B_DECODE
    k, v = cache["k"].clone(), cache["v"].clone()
    with pytest.raises(ValueError, match=f"max_len={T}"):
        port_lm.decode_step(cache, tok)
    assert torch.equal(cache["k"], k) and torch.equal(cache["v"], v)


def test_functional_decode_step_refuses_a_full_or_unknown_cache(port_lm):
    """lm_step's decode takes the host position beside the cache tensors:
    at pos == max_len it raises naming max_len before any write, and the
    model's decode_step refuses a cache dict that carries no position."""
    from repro_torch.configs.base import lm_step
    T = 3
    step = lm_step(port_lm, "decode_32k")
    cache = port_lm.init_cache(B_DECODE, T)
    tok = _t(np.zeros((B_DECODE, 1), np.int64))
    k, v, length = cache["k"], cache["v"], cache["len"]
    for pos in range(T):
        logits, k, v, length = step(tok, k, v, length, pos)
    assert logits.shape == (B_DECODE, 1, REDUCED.vocab)
    assert length.tolist() == [T] * B_DECODE
    k0, v0 = k.clone(), v.clone()
    with pytest.raises(ValueError, match=f"max_len={T}"):
        step(tok, k, v, length, T)
    assert torch.equal(k, k0) and torch.equal(v, v0)
    with pytest.raises(ValueError, match=f"max_len={T}"):
        port_lm.decode_step({"k": k, "v": v, "len": length}, tok)
    assert torch.equal(k, k0) and torch.equal(v, v0)


def test_jax_decode_past_the_cache_end_overwrites_the_last_row(jax_lm):
    """Reference fault R8, pinned: at cache_len == max_len the JAX decode
    raises nothing and writes the new k/v into row T - 1 (its
    dynamic_update_slice clamps the start index); the port refuses the
    same step (above)."""
    model, params = jax_lm
    T = 3
    decode = jax.jit(model.decode_step)
    cache = model.init_cache(B_DECODE, T)
    rng = np.random.default_rng(2)
    for _ in range(T):
        tok = jnp.asarray(rng.integers(0, REDUCED.vocab, (B_DECODE, 1)),
                          jnp.int32)
        _, cache = decode(params, cache, tok)
    before = np.asarray(cache["k"])
    tok = jnp.asarray(rng.integers(0, REDUCED.vocab, (B_DECODE, 1)),
                      jnp.int32)
    lg, cache = decode(params, cache, tok)
    after = np.asarray(cache["k"])
    assert np.asarray(cache["len"]).tolist() == [T + 1] * B_DECODE
    assert np.isfinite(np.asarray(lg)).all()
    np.testing.assert_array_equal(after[:, :, :, :T - 1],
                                  before[:, :, :, :T - 1])
    assert (after[:, :, :, T - 1] != before[:, :, :, T - 1]).any()


# ------------------------------------------------------------- configs
def test_input_specs_match_jax_shapes(jax_lm, port_lm):
    spec = get_arch(ARCH)
    for shape in LM_SHAPES:
        want = jax_lm_input_specs(jax_lm[0], shape)
        got = spec.input_specs(port_lm, shape)
        assert set(got) == set(want)
        for name, (shp, _) in got.items():
            assert shp == tuple(want[name].shape), (shape, name)


def test_full_config_is_the_published_one():
    jcfg = jax_get_arch(ARCH).build().cfg
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff",
              "vocab", "rope_theta", "dtype"):
        assert getattr(CONFIG, f) == getattr(jcfg, f), f
    c = CONFIG
    per_layer = (2 * c.d_model + c.d_model * c.head_dim
                 * (2 * c.n_heads + 2 * c.n_kv) + 3 * c.d_model * c.d_ff)
    assert (2 * c.vocab * c.d_model + c.d_model
            + c.n_layers * per_layer) == 12_247_782_400


def test_d3gnn_input_specs_match_jax_shapes():
    want = jax_get_arch("d3gnn-sage").input_specs(None, "stream_tick")
    got = get_arch("d3gnn-sage").input_specs(None, "stream_tick")
    assert got["now"][0] == ()
    for group in ("topo", "state0", "state1", "inbox", "eb", "rb"):
        for name, (shp, _) in got[group].items():
            assert shp == tuple(getattr(want[group], name).shape), name


def test_d3gnn_step_runs_an_empty_tick():
    """The d3gnn-sage step (both layers' ticks) on a tiny empty state: no
    record is valid, so nothing is emitted and no state changes."""
    from repro_torch.core.events import EdgeBatch, FeatBatch, ReplBatch
    from repro_torch.core.state import init_layer, init_topo
    spec = get_arch("d3gnn-sage")
    topo = init_topo(2, 8, 8, 8, "cpu")
    s0, s1 = init_layer(2, 8, 8, 8, "cpu"), init_layer(2, 8, 8, 8, "cpu")
    idx = lambda: torch.zeros(4, dtype=torch.int64)
    off = torch.zeros(4, dtype=torch.bool)
    inbox = FeatBatch(part=idx(), slot=idx(), feat=torch.zeros(4, 8),
                      valid=off)
    eb = EdgeBatch(part=idx(), edge_slot=idx(), src_slot=idx(),
                   dst_slot=idx(), dst_master_part=idx(),
                   dst_master_slot=idx(), valid=off)
    rb = ReplBatch(part=idx(), repl_slot=idx(), master_slot=idx(),
                   rep_part=idx(), rep_slot=idx(), valid=off)
    n0, n1, out = spec.step(spec.build_reduced(), "stream_tick")(
        topo, s0, s1, inbox, eb, rb, torch.tensor(0))
    assert not out.valid.any()
    for new, old in ((n0, s0), (n1, s1)):
        assert torch.equal(new.feat, old.feat)
        assert not new.red_pending.any() and not new.fwd_pending.any()


def test_unported_paths_raise():
    """Once the paths that raised: the train step (ported with the zoo's
    steps) and the MoE / remaining LM configs (ported with nn/moe.py).
    Each of the four archs now resolves, builds and takes JAX's
    parameters."""
    # the train step is ported now: it runs (parity with JAX's lm_step in
    # tests/test_torch_train_zoo.py)
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    model = get_arch(ARCH).build_reduced(device="cpu", train=True)
    params = param_tree(model)
    toks = torch.randint(0, REDUCED.vocab, (256, 4),
                         generator=torch.Generator().manual_seed(0))
    new, state, loss = get_arch(ARCH).step(model, "train_4k")(
        params, adam().init(params), toks, torch.roll(toks, -1, 1))
    assert bool(loss.isfinite()) and int(state["t"]) == 1
    assert not torch.equal(new["lm_head"], params["lm_head"])
    # the four configs of the MoE slice build and convert (their parity
    # with JAX: tests/test_torch_moe.py)
    for arch in ("llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b",
                 "internlm2-20b", "mistral-large-123b"):
        spec = get_arch(arch)
        assert spec.family == "lm" and spec.shapes is LM_SHAPES
        jm = jax_get_arch(arch).build_reduced()
        tree = jax.tree.map(np.asarray,
                            jax.jit(jm.init)(jax.random.key(0)))
        port = spec.build_reduced(device="cpu")
        assert port.cfg.pattern == jm.cfg.pattern
        port.load_state_dict(lm_params_from_numpy(tree, port.cfg))
        assert param_count(port) == jax_param_count(tree)


# ------------------------------------------------------------- serve CLI
def test_serve_reduced_cpu_prints_jax_line(capsys):
    model, generated, _ = serve.main(["--arch", ARCH, "--reduced",
                                      "--device", "cpu", "--tokens", "5"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"decoded 5 tokens x 4 seqs in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\)", line), line
    assert model.cfg is REDUCED and generated.shape == (4, 5)
    assert int(generated.max()) < REDUCED.vocab
