"""The port's segment-reduce wrappers (repro_torch.kernels.segment_reduce)
against the JAX package's Pallas ops in interpret mode, on the CPU, where
each wrapper runs its plain PyTorch version.

Tolerance: 1e-5 absolute and relative on floats (the JAX kernel sums by a
one-hot matmul, the port in sorted order); touched flags exactly equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.segment_reduce.ops import mean_rows as jax_mean_rows
from repro.kernels.segment_reduce.ops import \
    segment_deliver as jax_segment_deliver
from repro.kernels.segment_reduce.ops import \
    segment_sum_sorted as jax_segment_sum_sorted
from repro_torch.kernels.segment_reduce import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _both_deliver(idx, vec, cnt, n_rows, mode):
    want = jax_segment_deliver(jnp.asarray(idx, jnp.int32), jnp.asarray(vec),
                               jnp.asarray(cnt), n_rows, mode=mode,
                               block_e=64, block_v=64)
    got = ops.segment_deliver(torch.as_tensor(idx, dtype=torch.int64),
                              torch.as_tensor(vec), torch.as_tensor(cnt),
                              n_rows, mode=mode)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_deliver_equal(want, got):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_array_equal(got[2], want[2])


def _case(seed, C, R, d, oob=6):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, R + oob, C)          # negatives + past-the-end
    vec = rng.normal(size=(C, d)).astype(np.float32)
    cnt = rng.integers(-1, 3, C).astype(np.float32)
    return idx, vec, cnt


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("C,R,d", [(40, 25, 3), (300, 70, 9), (129, 200, 16)])
def test_segment_deliver_matches_jax(mode, C, R, d):
    want, got = _both_deliver(*_case(C * R + d, C, R, d), R, mode)
    _assert_deliver_equal(want, got)


def test_segment_deliver_last_writer_wins():
    idx = np.asarray([3, 5, 3, 3, 5])
    vec = np.arange(10, dtype=np.float32).reshape(5, 2)
    cnt = np.arange(5, dtype=np.float32)
    want, got = _both_deliver(idx, vec, cnt, 8, "set")
    _assert_deliver_equal(want, got)
    np.testing.assert_array_equal(got[0][3], [6.0, 7.0])      # record 3
    np.testing.assert_array_equal(got[0][5], [8.0, 9.0])      # record 4


@pytest.mark.parametrize("mode", ["add", "set"])
def test_segment_deliver_all_padding(mode):
    idx = np.full(32, 99)
    want, got = _both_deliver(idx, np.ones((32, 3), np.float32),
                              np.ones(32, np.float32), 16, mode)
    _assert_deliver_equal(want, got)
    assert not got[2].any() and not got[0].any()


def test_segment_deliver_single_segment():
    rng = np.random.default_rng(7)
    vec = rng.normal(size=(96, 5)).astype(np.float32)
    want, got = _both_deliver(np.full(96, 11), vec, np.ones(96, np.float32),
                              40, "add")
    _assert_deliver_equal(want, got)
    assert got[1][11] == 96 and got[2].sum() == 1


@pytest.mark.parametrize("mode", ["add", "set"])
def test_segment_deliver_sentinel_rows(mode):
    """Rows addressed at exactly n_rows (the local_index sentinel) and
    beyond drop; the last real row still receives its records."""
    R = 12
    idx = np.asarray([R, R - 1, R, 0, R + 1, R - 1, -1])
    vec = np.arange(14, dtype=np.float32).reshape(7, 2)
    want, got = _both_deliver(idx, vec, np.ones(7, np.float32), R, mode)
    _assert_deliver_equal(want, got)
    assert got[2].tolist() == [True] + [False] * (R - 2) + [True]


def test_segment_deliver_trimmed_tail():
    """n_rows not a multiple of the JAX block (64): the port returns
    exactly n_rows rows, and the tail rows carry their sums."""
    R = 70
    idx = np.asarray([69, 68, 69, 5, 64])
    vec = np.ones((5, 4), np.float32)
    want, got = _both_deliver(idx, vec, np.ones(5, np.float32), R, "add")
    assert got[0].shape == (R, 4) and want[0].shape == (R, 4)
    _assert_deliver_equal(want, got)
    assert got[1][69] == 2.0


@pytest.mark.parametrize("K,R,d", [(7, 20, 3), (130, 50, 16)])
def test_mean_rows_matches_jax(K, R, d):
    rng = np.random.default_rng(K + R)
    agg = rng.normal(size=(R, d)).astype(np.float32)
    cnt = rng.integers(-2, 5, R).astype(np.float32)       # incl. cnt <= 0
    rows = rng.integers(0, R, K)
    want = jax_mean_rows(jnp.asarray(agg[rows]), jnp.asarray(cnt[rows]),
                         block_r=64)
    got = ops.mean_rows(torch.as_tensor(agg), torch.as_tensor(cnt),
                        torch.as_tensor(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mean_rows_empty_count_reads_zero():
    sums = torch.tensor([[4.0, 8.0], [2.5, -1.0], [3.0, 3.0], [7.0, 7.0]])
    cnts = torch.tensor([2.0, 0.0, 1.0, -1.0])       # stale rows 1 and 3
    want = [[2.0, 4.0], [0.0, 0.0], [3.0, 3.0], [0.0, 0.0]]
    np.testing.assert_array_equal(ops.mean_rows(sums, cnts).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax_mean_rows(jnp.asarray(sums.numpy()),
                                 jnp.asarray(cnts.numpy()), block_r=64)),
        want)


@pytest.mark.parametrize("E,n,W", [(200, 37, 5), (64, 64, 8), (0, 9, 3)])
def test_segment_sum_sorted_matches_jax(E, n, W):
    """Sorted ids with empty segments and padding ids >= n at the tail."""
    rng = np.random.default_rng(E + n)
    seg = np.sort(rng.integers(0, n + 4, E))
    msgs = rng.normal(size=(E, W)).astype(np.float32)
    want = jax_segment_sum_sorted(jnp.asarray(msgs), jnp.asarray(seg,
                                                                  jnp.int32),
                                  n, block_e=64, block_v=64)
    got = ops.segment_sum_sorted(torch.as_tensor(msgs), torch.as_tensor(seg),
                                 n)
    assert got.shape == (n, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_sum_rows_empty_runs_and_padding():
    """Kernel A's contract on its plain version: empty runs read zero and
    rows past row_ptr[-1] are never summed."""
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    seg = torch.tensor([0, 0, 2, 3, 3, 4])           # row 5 is padding
    row_ptr = torch.tensor([0, 2, 2, 3, 5])
    out = ref.segment_sum_rows_ref(rows, seg, row_ptr)
    np.testing.assert_array_equal(
        out.numpy(), [[2.0, 4.0], [0.0, 0.0], [4.0, 5.0], [14.0, 16.0]])
    np.testing.assert_array_equal(ops.segment_sum_rows(rows, seg, row_ptr),
                                  out)


def test_wrappers_count_no_launch_on_cpu():
    ops.reset_launches()
    ops.segment_deliver(torch.tensor([0, 1]), torch.ones(2, 3),
                        torch.ones(2), 4)
    ops.mean_rows(torch.ones(3, 2), torch.ones(3))
    assert ops.LAUNCHES == {"segment_sum_rows": 0, "mean_rows_gather": 0}
