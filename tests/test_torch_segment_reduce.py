"""The port's segment-reduce wrappers (repro_torch.kernels.segment_reduce)
against the JAX package's Pallas ops in interpret mode, on the CPU, where
each wrapper runs its plain PyTorch version; and the merge-path partition
of kernel A (`ops.delivery_plan`), with the kernel's share-by-share
arithmetic (carries, then the fixup of cut runs) replayed in numpy.

Tolerance: 1e-5 absolute and relative on floats (the JAX kernel sums by a
one-hot matmul, the port in sorted order); 1e-6 for the fused forms with a
base (the base added once, in numpy beside JAX); touched flags and counts
of +-1 exactly equal; the kernel and scatter delivery backends within
KA_TOL x (1 + sum of magnitudes) of each other (f32 sums in two orders).
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
from repro_torch.core.delivery import KernelDelivery, ScatterDelivery
from repro_torch.kernels.segment_reduce import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_TOL = dict(rtol=1e-6, atol=1e-6)
KA_TOL = 1e-5


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


# ------------------------------------------------ kernel A's gather form
def _runs(seed, n, C, hub=None, drop=0.3):
    """Destinations of C records into n rows (a share `drop` dropped, at
    -1 or past the end), their stable sort (order, row_ptr) and payload."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(n, 1), C)
    if hub is not None:
        idx[rng.random(C) < 0.6] = hub
    gone = rng.random(C) < drop
    idx[gone] = rng.choice([-1, n, n + 3], gone.sum())
    vec = rng.normal(size=(C, 5)).astype(np.float32)
    cnt = rng.integers(-1, 3, C).astype(np.float32)
    order, row_ptr = ops.sort_runs(torch.as_tensor(idx), n)
    return idx, vec, cnt, order.numpy(), row_ptr.numpy()


PLAN_CASES = [  # (n rows, C records, hub row, drop share, share)
    (0, 10, None, 0.3, 4),        # empty table
    (9, 40, None, 1.0, 4),        # all padding
    (30, 500, 7, 0.2, 8),         # one hub run across many shares
    (3, 200, None, 0.1, 64),      # n < shares' items: rows far fewer
    (50, 0, None, 0.0, 4),        # no records at all
    (200, 700, 0, 0.3, 16)]


@pytest.mark.parametrize("n,C,hub,drop,share", PLAN_CASES)
def test_delivery_plan_covers_rows_and_records_once(n, C, hub, drop, share):
    """Shares tile the merge path: every row end and every live record
    lies in exactly one share, each share holds `share` items (the last
    live one fewer; shares past the end none), and at each boundary only
    the run of the row in progress can be cut."""
    _, _, _, _, row_ptr = _runs(n * 7 + C, n, C, hub, drop)
    plan = ops.delivery_plan(torch.as_tensor(row_ptr), C, share).numpy()
    rows, recs = plan
    live = row_ptr[-1]
    assert plan.shape == (2, max(1, -(-(n + C) // share)) + 1)
    assert rows[0] == recs[0] == 0 and rows[-1] == n and recs[-1] == live
    assert (np.diff(rows) >= 0).all() and (np.diff(recs) >= 0).all()
    items = np.diff(rows) + np.diff(recs)
    full = (np.arange(len(items)) + 1) * share <= n + live
    assert (items[full] == share).all() and (items[~full] <= share).all()
    assert items.sum() == n + live
    for i, j in zip(rows[:-1], recs[:-1]):
        # on the path: rows < i ended, row i's records partly consumed
        assert i == n or row_ptr[i] <= j <= row_ptr[i + 1]
        assert i < n or j == live
    if hub is not None:
        cuts = (rows[1:-1] == hub) & (recs[1:-1] > row_ptr[hub])
        assert cuts.sum() >= 3      # the hub run spans several shares


def _replay_add(vec, row_ptr, order, cnt, base, base_cnt, share):
    """segment_reduce.cu's add path in numpy, share by share (f32): each
    share writes the rows that end in it, base added, and its tail partial
    to its carry slot; then the fixup adds a cut run's carries, in 16
    contiguous slices as the CTA's warps sum them, then its head partial,
    then the base. Outputs start as NaN, so a row no share writes shows."""
    n, d = len(row_ptr) - 1, vec.shape[1]
    plan = ops.delivery_plan(torch.as_tensor(row_ptr), len(order),
                             share).numpy()
    n_shares = plan.shape[1] - 1
    out = np.full((n, d), np.nan, np.float32)
    cnt_out = np.full(n, np.nan, np.float32)
    flag = np.zeros(n, bool)
    carry = np.full((n_shares, d), np.nan, np.float32)
    carry_cnt = np.full(n_shares, np.nan, np.float32)
    for s in range(n_shares):
        i0, i1 = plan[0, s], plan[0, s + 1]
        j0, j1 = plan[1, s], plan[1, s + 1]
        if i0 == i1 and j0 == j1:
            continue
        r, j, start = i0, j0, row_ptr[i0]
        head_cut = j0 > start
        acc, cacc = np.zeros(d, np.float32), np.float32(0)
        while True:
            end = row_ptr[r + 1] if r < i1 else j1
            for jj in range(j, end):
                acc = acc + vec[order[jj]]
                cacc = cacc + cnt[order[jj]]
            j = end
            if r >= i1:
                break
            cut = r == i0 and head_cut
            out[r] = acc if cut else base[r] + acc
            cnt_out[r] = cacc if cut else base_cnt[r] + cacc
            flag[r] = end > start
            acc, cacc, start, r = np.zeros(d, np.float32), np.float32(0), \
                end, r + 1
        if i1 < n and j1 > start:
            carry[s], carry_cnt[s] = acc, cacc
    for s in range(1, n_shares):
        r = plan[0, s]
        if r >= n:
            continue
        lo = row_ptr[r]
        if not (plan[1, s] > lo and s == (lo + r) // share + 1):
            continue
        sa, sb = s - 1, (row_ptr[r + 1] + r) // share
        m = sb - sa
        tot, tc = np.zeros(d, np.float32), np.float32(0)
        for w in range(16):
            part, pc = np.zeros(d, np.float32), np.float32(0)
            for c in range(sa + m * w // 16, sa + m * (w + 1) // 16):
                part, pc = part + carry[c], pc + carry_cnt[c]
            tot, tc = tot + part, tc + pc
        out[r] = base[r] + (tot + out[r])
        cnt_out[r] = base_cnt[r] + (tc + cnt_out[r])
    return out, cnt_out, flag


@pytest.mark.parametrize("n,C,hub,drop,share", PLAN_CASES)
def test_merge_path_replay_matches_plain_sums(n, C, hub, drop, share):
    """Carries and the fixup of cut runs give every row the plain
    version's sum: no row is missed, none counted twice."""
    _, vec, cnt, order, row_ptr = _runs(n * 7 + C, n, C, hub, drop)
    rng = np.random.default_rng(n + C)
    base = rng.normal(size=(n, vec.shape[1])).astype(np.float32)
    base_cnt = rng.integers(0, 4, n).astype(np.float32)
    got = _replay_add(vec, row_ptr, order, cnt, base, base_cnt, share)
    want = ref.deliver_rows_ref(
        torch.as_tensor(vec), torch.as_tensor(row_ptr),
        torch.as_tensor(order), torch.as_tensor(cnt), torch.as_tensor(base),
        torch.as_tensor(base_cnt), "add")
    np.testing.assert_allclose(got[0], want[0].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("C,R,d", [(40, 25, 3), (300, 70, 9), (129, 200, 16)])
def test_fused_delivery_with_base_matches_jax(mode, C, R, d):
    """deliver_rows with a base = JAX segment_deliver (interpret mode) with
    the base added in numpy (add) or kept where no record lands (set)."""
    idx, vec, cnt = _case(C * R + d + 1, C, R, d)
    rng = np.random.default_rng(C + R)
    base = rng.normal(size=(R, d)).astype(np.float32)
    base_cnt = rng.integers(0, 5, R).astype(np.float32)
    want, _ = _both_deliver(idx, vec, cnt, R, mode)
    if mode == "add":
        want_vec, want_cnt = base + want[0], base_cnt + want[1]
    else:
        want_vec = np.where(want[2][:, None], want[0], base)
        want_cnt = np.where(want[2], want[1], base_cnt)
    order, row_ptr = ops.sort_runs(torch.as_tensor(idx), R)
    got = ops.deliver_rows(torch.as_tensor(vec), row_ptr, order,
                           torch.as_tensor(cnt), torch.as_tensor(base),
                           torch.as_tensor(base_cnt), mode=mode)
    np.testing.assert_allclose(got[0].numpy(), want_vec, **FUSED_TOL)
    np.testing.assert_allclose(got[1].numpy(), want_cnt, **FUSED_TOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("C,R,d,hub", [(40, 25, 3, None), (600, 70, 9, 4),
                                       (300, 1, 2, 0), (50, 30, 1, None)])
def test_kernel_delivery_equals_scatter_delivery(mode, C, R, d, hub):
    """The two delivery backends on the CPU: flags and counts exact, sums
    within KA_TOL of each other, set rows equal."""
    idx, vec, cnt = _case(C + R + d, C, R, d)
    if hub is not None:
        idx[::3] = hub
    rng = np.random.default_rng(C * d)
    dst = torch.as_tensor(rng.normal(size=(R, d)).astype(np.float32))
    cnt0 = torch.as_tensor(rng.integers(0, 3, R).astype(np.float32))
    idx, vec, cnt = (torch.as_tensor(idx), torch.as_tensor(vec),
                     torch.as_tensor(cnt))
    kd, sd = KernelDelivery(), ScatterDelivery()
    if mode == "set":
        got, want = kd.deliver_set(dst, idx, vec), sd.deliver_set(dst, idx,
                                                                  vec)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    got = kd.deliver_add(dst, cnt0, idx, vec, cnt)
    want = sd.deliver_add(dst, cnt0, idx, vec, cnt)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    absum = sd.deliver_add(dst.abs(), cnt0, idx, vec.abs(), cnt)[0]
    assert bool(((got[0] - want[0]).abs() <= KA_TOL * (1 + absum)).all())


def test_contiguous_form_is_deliver_rows_without_order():
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    row_ptr = torch.tensor([0, 2, 2, 3, 5])
    out, cnt_out, flag = ops.deliver_rows(rows, row_ptr)
    assert cnt_out is None
    np.testing.assert_array_equal(
        out.numpy(), [[2.0, 4.0], [0.0, 0.0], [4.0, 5.0], [14.0, 16.0]])
    assert flag.tolist() == [True, False, True, True]
    last, _, _ = ops.deliver_rows(rows, row_ptr, mode="set",
                                  base=torch.full((4, 2), -1.0))
    np.testing.assert_array_equal(
        last.numpy(), [[2.0, 3.0], [-1.0, -1.0], [4.0, 5.0], [8.0, 9.0]])


def test_run_offsets_is_a_searchsorted_of_the_sorted_ids():
    """row_ptr[r] = number of ids < r; ids >= n (padding) end every run."""
    seg = torch.tensor([0, 0, 2, 3, 3, 3, 5, 9, 9])
    np.testing.assert_array_equal(ops.run_offsets(seg, 5).numpy(),
                                  [0, 2, 2, 3, 6, 6])
    np.testing.assert_array_equal(ops.run_offsets(seg[:0], 3).numpy(),
                                  [0, 0, 0, 0])


def test_deliver_rows_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="mode"):
        ops.deliver_rows(torch.ones(2, 2), torch.tensor([0, 2]), mode="max")
    with pytest.raises(ValueError, match="base_cnt"):
        ops.deliver_rows(torch.ones(2, 2), torch.tensor([0, 2]),
                         base_cnt=torch.ones(1))
