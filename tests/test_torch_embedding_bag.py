"""The port's embedding bag (repro_torch.kernels.embedding_bag and
repro_torch.recsys.embedding_bag) against the JAX package on the CPU.

The port's wrapper runs its plain version for CPU tensors; the JAX side
runs `repro.kernels.embedding_bag.ops.embedding_bag` (the Pallas kernel in
interpret mode, block_b=32, as tests/test_kernels.py runs it) and the
plain lookup. Same ids and table from numpy; f32 sums of at most W rows:
rtol = atol = 1e-6 (the JAX pair agrees exactly).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref
from repro.recsys.embedding_bag import \
    embedding_bag_segment as jax_embedding_bag_segment
from repro_torch.kernels.embedding_bag import ops, ref
from repro_torch.recsys.embedding_bag import (EmbeddingBag,
                                              embedding_bag_lookup,
                                              embedding_bag_segment)

TOL = dict(rtol=1e-6, atol=1e-6)


def _table(rng, V, d):
    return rng.normal(size=(V, d)).astype(np.float32)


def _both(table, ids, mode):
    """(port wrapper on CPU, JAX Pallas interpret, JAX plain lookup)."""
    got = ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                            mode).numpy()
    tj, ij = jnp.asarray(table), jnp.asarray(ids.astype(np.int32))
    return (got, np.asarray(jax_embedding_bag(tj, ij, mode=mode, block_b=32)),
            np.asarray(jax_ref(tj, ij, mode=mode)))


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("V,d,B,W,mode", [
    (1000, 32, 128, 8, "mean"),
    (500, 64, 64, 4, "sum"),
    (100, 16, 256, 2, "mean"),
    (2048, 128, 64, 16, "sum"),
])
def test_matches_jax_kernel_and_lookup(V, d, B, W, mode, id_dtype):
    rng = np.random.default_rng(V + B)
    table = _table(rng, V, d)
    ids = rng.integers(-1, V, (B, W)).astype(id_dtype)
    got, pallas, plain = _both(table, ids, mode)
    assert got.shape == (B, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_all_padding_bags_read_zero(mode):
    table = np.ones((10, 8), np.float32)
    ids = np.full((32, 4), -1, np.int64)
    ids[::2, 1] = 3                    # every other bag holds one id
    got, pallas, plain = _both(table, ids, mode)
    np.testing.assert_array_equal(got[1::2], 0.0)
    np.testing.assert_array_equal(got[::2], 1.0)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_any_negative_id_is_padding(mode):
    rng = np.random.default_rng(7)
    table = _table(rng, 50, 24)
    ids = rng.integers(-9, 50, (64, 6)).astype(np.int64)
    assert (ids < -1).any()
    got, pallas, plain = _both(table, ids, mode)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_out_of_range_id_makes_its_bag_nan(mode):
    """An id >= V makes its bag NaN (jnp.take's fill mode), and only its
    bag: the port equals the JAX lookup. The Pallas path spreads the NaN
    to every bag of the id's 32-bag block (0 * NaN in its one-hot matmul,
    ROADMAP Queue 3); its other blocks agree with the port."""
    rng = np.random.default_rng(3)
    V = 40
    table = _table(rng, V, 16)
    ids = rng.integers(-1, V, (64, 5)).astype(np.int64)
    ids[3, 2], ids[9, 0] = V, V + 17           # both in block 0
    got, pallas, plain = _both(table, ids, mode)
    nan_bags = np.isnan(got).any(axis=1)
    np.testing.assert_array_equal(np.flatnonzero(nan_bags), [3, 9])
    assert np.isnan(got[nan_bags]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    np.testing.assert_allclose(got[~nan_bags], plain[~nan_bags], **TOL)
    assert np.isnan(pallas[:32]).all()
    np.testing.assert_allclose(got[32:], pallas[32:], **TOL)


@pytest.mark.parametrize("B,W", [(0, 4), (5, 0), (100, 3)])
def test_any_bag_count_and_width(B, W):
    """B = 0, W = 0 and a B that is no multiple of 64 (which the JAX
    kernel refuses) against the JAX lookup."""
    rng = np.random.default_rng(B + W)
    table = _table(rng, 30, 12)
    ids = rng.integers(-1, 30, (B, W)).astype(np.int64)
    got = ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                            "mean").numpy()
    want = np.asarray(jax_ref(jnp.asarray(table),
                              jnp.asarray(ids.astype(np.int32)), "mean"))
    assert got.shape == (B, 12)
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_path_launches_nothing():
    ops.reset_launches()
    table = torch.ones(4, 8)
    ops.embedding_bag(table, torch.tensor([[0, 1], [2, -1]]), "sum")
    assert ops.LAUNCHES == {"embedding_bag": 0}


def test_wrapper_raises_on_what_it_does_not_take():
    table = torch.zeros(4, 8)
    ids = torch.zeros(2, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(table, ids, "max")
    with pytest.raises(ValueError, match=r"\[B, W\]"):
        ops.embedding_bag(table, ids[0], "sum")
    with pytest.raises(ValueError, match="int32 or int64"):
        ops.embedding_bag(table, ids.float(), "sum")
    with pytest.raises(ValueError, match="on meta"):
        ops.embedding_bag(table, ids.to("meta"), "sum")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_module_and_lookup(mode):
    """EmbeddingBag.forward (the kernel's wrapper) equals the plain
    lookup, and the lookup equals the JAX one; the table is
    normal(0, init_std) in f32."""
    bag = EmbeddingBag(300, 16, mode=mode, init_std=0.01, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert bag.table.dtype == torch.float32 and not bag.table.requires_grad
    assert abs(float(bag.table.std()) - 0.01) < 1e-3
    ids = torch.as_tensor(np.random.default_rng(1).integers(-1, 300, (40, 5)))
    got = bag(ids)
    torch.testing.assert_close(got, embedding_bag_lookup(bag.table, ids, mode),
                               rtol=0, atol=0)
    want = jax_ref(jnp.asarray(bag.table.numpy()),
                   jnp.asarray(ids.numpy().astype(np.int32)), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ref.embedding_bag_ref is embedding_bag_lookup


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_segment_form_matches_jax(mode):
    """The offsets form: an empty bag, a wrapped negative flat id, a flat
    id past the table (NaN row) and a dropped bag id, as JAX treats
    them."""
    rng = np.random.default_rng(5)
    table = _table(rng, 20, 8)
    flat = np.array([1, 2, -1, 4, 25, 6, 7, 8, 9], np.int64)
    seg = np.array([0, 0, 0, 2, 3, 3, 4, 4, 9], np.int64)
    got = embedding_bag_segment(torch.as_tensor(table), torch.as_tensor(flat),
                                torch.as_tensor(seg), 5, mode).numpy()
    want = np.asarray(jax_embedding_bag_segment(
        jnp.asarray(table), jnp.asarray(flat.astype(np.int32)),
        jnp.asarray(seg.astype(np.int32)), 5, mode))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]).all() and not np.isnan(np.delete(got, 3, 0)).any()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **TOL)
