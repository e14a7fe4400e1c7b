"""The port's two-tower serve path (repro_torch.recsys, nn.layers.MLP,
configs.two_tower_retrieval, convert, launch.serve) against the JAX
package on the CPU, on two-tower-retrieval's REDUCED config with the
parameters of JAX's `TwoTower.init` carried over by
`convert.two_tower_params_from_numpy`.

Tolerance: |port - jax| <= 1e-5 * (1 + |jax|), ROADMAP's float contract
scaled by the magnitude: scores are divided by the 0.05 temperature.
The full-width model is never built here: its tables are 61 GB.
"""
import dataclasses
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import two_tower_retrieval as jax_cfg
from repro.nn import layers as jlayers
from repro.nn.module import param_count as jax_param_count
from repro.recsys import two_tower as jax_two_tower
from repro_torch.configs import get_arch, two_tower_retrieval as cfg_mod
from repro_torch.convert import two_tower_params_from_numpy
from repro_torch.launch import serve
from repro_torch.nn import layers
from repro_torch.nn.module import param_count
from repro_torch.recsys import two_tower
from repro_torch.recsys.two_tower import TwoTower

ARCH = "two-tower-retrieval"
B = 48                  # paired users / items
N_CAND = 300            # retrieval candidates


def assert_close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol * (1 + np.abs(want))).all(), float(err.max())


def bag_ids(rng, n, fields, width, vocab):
    """[n, fields, width] ids: each bag's length uniform on 0..width, -1
    after it, ids uniform over the vocab."""
    ids = rng.integers(0, vocab, (n, fields, width))
    lengths = rng.integers(0, width + 1, (n, fields, 1))
    return np.where(np.arange(width) < lengths, ids, -1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_model():
    model = jax_get_arch(ARCH).build_reduced()
    return model, model.init(jax.random.key(0))


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params = jax_model
    model = TwoTower(cfg_mod.REDUCED, device="cpu", seed=1)
    model.load_state_dict(two_tower_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def inputs():
    c = cfg_mod.REDUCED
    rng = np.random.default_rng(0)
    return {"user_ids": bag_ids(rng, B, c.user_fields, c.max_ids_per_field,
                                c.user_vocab),
            "item_ids": bag_ids(rng, B, c.item_fields, c.max_ids_per_field,
                                c.item_vocab),
            "cand_ids": bag_ids(rng, N_CAND, c.item_fields,
                                c.max_ids_per_field, c.item_vocab)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_converted_params_load_exactly(jax_model, port_model):
    model, params = jax_model
    assert param_count(port_model) == jax_param_count(params)
    sd = port_model.state_dict()
    np.testing.assert_array_equal(sd["user_emb.table"].numpy(),
                                  np.asarray(params["user_emb"]["table"]))
    np.testing.assert_array_equal(sd["item_mlp.layers.1.w"].numpy(),
                                  np.asarray(params["item_mlp"]["l1"]["w"]))


@pytest.mark.parametrize("tower", ["user_tower", "item_tower"])
def test_towers_match_jax(jax_model, port_model, inputs, tower):
    model, params = jax_model
    key = "user_ids" if tower == "user_tower" else "item_ids"
    want = getattr(model, tower)(params, jnp.asarray(inputs[key]))
    got = getattr(port_model, tower)(torch.as_tensor(inputs[key]))
    assert_close(got, want)
    # unit norm, but for a user/item with no id at all: its bags, and with
    # zero biases its vector, are 0
    empty = (inputs[key] < 0).all(axis=(1, 2))
    norms = got.norm(dim=-1).numpy()
    np.testing.assert_allclose(norms[~empty], 1.0, atol=1e-5)
    np.testing.assert_array_equal(norms[empty], 0.0)


def test_score_and_retrieval_match_jax(jax_model, port_model, inputs):
    model, params = jax_model
    u, i, c = (inputs[k] for k in ("user_ids", "item_ids", "cand_ids"))
    assert_close(port_model.score(torch.as_tensor(u), torch.as_tensor(i)),
                 model.score(params, jnp.asarray(u), jnp.asarray(i)))
    got = port_model.retrieval_scores(torch.as_tensor(u[:2]),
                                      torch.as_tensor(c))
    assert got.shape == (2, N_CAND)
    assert_close(got, model.retrieval_scores(params, jnp.asarray(u[:2]),
                                             jnp.asarray(c)))


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_serve_steps_match_jax(jax_model, port_model, inputs, shape):
    model, params = jax_model
    batch = {"user_ids": inputs["user_ids"]}
    if shape == "serve_bulk":
        batch["item_ids"] = inputs["item_ids"]
    if shape == "retrieval_cand":
        batch = {"user_ids": inputs["user_ids"][:1],
                 "cand_ids": inputs["cand_ids"]}
    want = jax_cfg.step(model, shape)(params, _jnp(batch))
    got = get_arch(ARCH).step(port_model, shape)(_torch(batch))
    assert_close(got, want)


def test_embedding_fields_mlp_and_l2_normalize_match_jax(jax_model,
                                                         port_model, inputs):
    model, params = jax_model
    ids = inputs["user_ids"]
    e_jax = jax_two_tower.embedding_fields(model.user_emb, params["user_emb"],
                                           jnp.asarray(ids))
    e = two_tower.embedding_fields(port_model.user_emb, torch.as_tensor(ids))
    assert_close(e, e_jax)
    assert_close(port_model.user_mlp(e),
                 model.user_mlp(params["user_mlp"], e_jax))
    x = np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32)
    x[0] = 0.0                                  # the eps floor
    x[1] *= 1e-9
    assert_close(two_tower.l2_normalize(torch.as_tensor(x)),
                 jax_two_tower.l2_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("dims", [(12, 7), (10, 16, 8, 4)])
def test_mlp_matches_jax(dims):
    rng = np.random.default_rng(len(dims))
    jm = jlayers.MLP(dims)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    pm = layers.MLP(dims)
    pm.load_state_dict({f"layers.{i}.{leaf}": torch.tensor(a)
                        for i in range(len(dims) - 1)
                        for leaf, a in params[f"l{i}"].items()})
    x = rng.normal(size=(9, dims[0])).astype(np.float32)
    assert_close(pm(torch.as_tensor(x)),
                 jm(params, jnp.asarray(x)))


def test_linear_draws_on_its_device():
    gen = torch.Generator().manual_seed(0)
    lin = layers.Linear(8, 4, generator=gen, device="cpu")
    assert lin.w.device.type == "cpu" and lin.b.device.type == "cpu"
    again = layers.Linear(8, 4, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(lin.w, again.w, rtol=0, atol=0)


def test_config_matches_jax_and_build_applies_the_one_card_cut(monkeypatch):
    for ours, theirs in ((cfg_mod.CONFIG, jax_cfg.CONFIG),
                         (cfg_mod.REDUCED, jax_cfg.REDUCED)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert cfg_mod.CONFIG.user_vocab == 100_000_256
    assert cfg_mod.ONE_CARD_USER_VOCAB == 50_000_384
    assert cfg_mod.ONE_CARD_USER_VOCAB % 512 == 0
    spec = get_arch(ARCH)
    assert spec.family == "recsys" == jax_get_arch(ARCH).family
    built = {}
    monkeypatch.setattr(cfg_mod, "TwoTower",
                        lambda cfg, device, seed: built.setdefault("cfg", cfg))
    spec.build(device="cpu")
    assert built["cfg"] == dataclasses.replace(
        cfg_mod.CONFIG, user_vocab=cfg_mod.ONE_CARD_USER_VOCAB)


def test_shapes_and_input_specs_match_jax(port_model, jax_model):
    model, _ = jax_model
    assert cfg_mod.SHAPES == {k: type(cfg_mod.SHAPES[k])(
        v.name, v.kind, dict(v.dims), v.note)
        for k, v in jax_cfg.SHAPES.items()}
    dtypes = {jnp.int32: torch.int32, jnp.float32: torch.float32}
    for shape in jax_cfg.SHAPES:
        ours = get_arch(ARCH).input_specs(port_model, shape)
        theirs = jax_cfg.input_specs(model, shape)
        assert set(ours) == set(theirs)
        for name, (dims, dtype) in ours.items():
            assert dims == theirs[name].shape
            assert dtype == dtypes[theirs[name].dtype.type]


def test_train_step_raises(port_model, inputs):
    """The train step is ported now: train_batch runs (parity with JAX's
    step in tests/test_torch_train_zoo.py) and leaves the model as it was."""
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    params = param_tree(port_model)
    batch = {"user_ids": torch.tensor(inputs["user_ids"]),
             "item_ids": torch.tensor(inputs["item_ids"]),
             "item_logq": torch.full((B,), -3.0)}
    new, state, loss = get_arch(ARCH).step(port_model, "train_batch")(
        params, adam().init(params), batch)
    assert bool(loss.isfinite()) and int(state["t"]) == 1
    assert set(new) == set(params)
    assert not torch.equal(new["user_emb.table"], params["user_emb.table"])
    for name, p in port_model.named_parameters():
        assert p.data_ptr() == params[name].data_ptr()


def test_serve_cli_reduced_on_cpu(capsys):
    model, ids, vectors, secs = serve.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(
        r"served 2 requests x 512 users in \d+\.\d+s \(\d+\.\d users/s, "
        r"p50 \d+\.\d{3} ms, p99 \d+\.\d{3} ms per request\)", line), line
    c = cfg_mod.REDUCED
    assert len(secs) == 2
    assert ids.shape == (512, c.user_fields, c.max_ids_per_field)
    assert int(ids.min()) >= -1 and int(ids.max()) < c.user_vocab
    assert vectors.shape == (512, c.tower_mlp[-1])
    torch.testing.assert_close(vectors, model.user_tower(ids))
