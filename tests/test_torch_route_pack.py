"""The port's routing-plane pieces against the JAX package, on the CPU:
`kernels/route_pack` (route_plan, the plain route_pack the wrapper runs
for CPU tensors), the packed wire format (`dist/wire.py`) and the
LocalRouter's route_lanes.

Tolerances: all exact. route_plan's order, masks and slots equal JAX's;
the plain route_pack equals JAX's "xla" backend bit for bit (int32 views,
NaN payloads, Inf and -0.0 included) and the Pallas backend (interpret
mode) value for value on finite rows; packed rows and their round trips
equal JAX's exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.events import FeatBatch as JaxFeatBatch
from repro.core.events import MsgBatch as JaxMsgBatch
from repro.dist import wire as jax_wire
from repro.kernels.route_pack import route_pack as jax_route_pack
from repro.kernels.route_pack import route_plan as jax_route_plan
from repro.kernels.route_pack import route_plan_ref as jax_route_plan_ref
from repro_torch.core.events import FeatBatch, MsgBatch
from repro_torch.dist import wire
from repro_torch.dist.router import LocalRouter
from repro_torch.kernels.route_pack import ops, ref


def plan_case(seed, n, D, skew):
    """dst [n] over D destinations plus out-of-range ones, ok [n]; `skew`
    sends ~75% of the records to destination 0 (a hub's owner)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, D + 2, n)
    if skew:
        dst = np.where(rng.random(n) < 0.75, 0, dst)
    return dst, rng.random(n) < 0.7


def _caps(n, D):
    return {"1": 1, "2": 2, "C//D": max(1, n // D), "C": n}


def _jax_plan(dst, ok, D, cap):
    return [np.asarray(a) for a in jax_route_plan(
        jnp.asarray(dst, jnp.int32), jnp.asarray(ok), D, cap)]


def _port_plan(dst, ok, D, cap):
    return [t.numpy() for t in ops.route_plan(
        torch.as_tensor(dst, dtype=torch.int64), torch.as_tensor(ok), D,
        cap)]


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("skew", [False, True], ids=["random", "hub"])
@pytest.mark.parametrize("cap_name", ["1", "2", "C//D", "C"])
def test_route_plan_equals_jax(D, skew, cap_name):
    n = 203
    dst, ok = plan_case(D * 10 + skew, n, D, skew)
    cap = _caps(n, D)[cap_name]
    want = _jax_plan(dst, ok, D, cap)
    order, ship, slot, left, starts = _port_plan(dst, ok, D, cap)
    for name, w, g in zip(("order", "ship_s", "slot_s", "left_s"), want,
                          (order, ship, slot, left)):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # starts: the first sorted position of every destination
    live = ok & (dst >= 0) & (dst < D)
    counts = np.bincount(dst[live], minlength=D)
    np.testing.assert_array_equal(starts, np.concatenate(
        [[0], np.cumsum(counts)]))
    # the O(N * D) reference plans agree too (original record order)
    got_ref = [t.numpy() for t in ref.route_plan_ref(
        torch.as_tensor(dst), torch.as_tensor(ok), D, cap)]
    want_ref = jax_route_plan_ref(jnp.asarray(dst, jnp.int32),
                                  jnp.asarray(ok), D, cap)
    for g, w in zip(got_ref, want_ref):
        np.testing.assert_array_equal(g, np.asarray(w))


def special_rows(seed, n, W):
    """f32 rows [n, W] with NaNs of several payloads, +-Inf and -0.0."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, W)).astype(np.float32)
    bits = rows.view(np.int32)
    flat = bits.reshape(-1)
    k = flat.size
    if k:
        pick = rng.choice(k, size=min(k, 12), replace=False)
        specials = np.array([0x7FC00000, 0x7F800001, 0xFFC01234, 0x7F800000,
                             0xFF800000, 0x80000000], np.uint32).view(
            np.int32)
        flat[pick] = specials[np.arange(len(pick)) % len(specials)]
    return rows


PACK_CASES = {
    # name: (N, D, cap, W, skew, live fraction)
    "empty": (0, 4, 3, 5, 0, 1.0),
    "all-dropped": (40, 4, 3, 5, 0, 0.0),
    "every-bucket-overflows": (90, 4, 2, 69, 0, 1.0),
    "cap1": (33, 2, 1, 5, 1, 0.8),
    "D2-W1": (57, 2, 9, 1, 0, 0.7),
    "D4-W607-hub": (300, 4, 40, 607, 1, 0.8),
    "dense": (64, 4, 64, 12, 1, 1.0),
}


def pack_inputs(name):
    N, D, cap, W, skew, frac = PACK_CASES[name]
    rng = np.random.default_rng(len(name))
    dst = rng.integers(0, D, N)
    if skew:
        dst = np.where(rng.random(N) < 0.75, 0, dst)
    ok = rng.random(N) < frac
    return special_rows(N + W, N, W), dst, ok, D, cap


@pytest.mark.parametrize("name", sorted(PACK_CASES))
def test_route_pack_plain_bit_equal_to_jax_xla(name):
    rows, dst, ok, D, cap = pack_inputs(name)
    order, _, slot_s, _, starts = ops.route_plan(
        torch.as_tensor(dst), torch.as_tensor(ok), D, cap)
    ops.reset_launches()
    got = ops.route_pack(torch.as_tensor(rows), order, slot_s, starts, D,
                         cap).numpy()
    assert ops.LAUNCHES["route_pack"] == 0, "a CPU tensor ran the kernel"
    j_order, _, j_slot, _ = _jax_plan(dst, ok, D, cap)
    want = np.asarray(jax_route_pack(jnp.asarray(rows)[j_order],
                                     jnp.asarray(j_slot), D * cap,
                                     backend="xla"))
    assert got.shape == want.shape == (D * cap, rows.shape[1])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the plain version on its own, as route_pack_ref is called
    again = ref.route_pack_ref(torch.as_tensor(rows)[order], slot_s, D * cap)
    np.testing.assert_array_equal(again.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("name", ["every-bucket-overflows", "cap1",
                                  "D4-W607-hub"])
def test_route_pack_plain_value_equal_to_jax_pallas(name):
    rows, dst, ok, D, cap = pack_inputs(name)
    rows = np.nan_to_num(rows, nan=1.5, posinf=2.5, neginf=-2.5)
    order, _, slot_s, _, starts = ops.route_plan(
        torch.as_tensor(dst), torch.as_tensor(ok), D, cap)
    got = ops.route_pack(torch.as_tensor(rows), order, slot_s, starts, D,
                         cap).numpy()
    j_order, _, j_slot, _ = _jax_plan(dst, ok, D, cap)
    want = np.asarray(jax_route_pack(jnp.asarray(rows)[j_order],
                                     jnp.asarray(j_slot), D * cap,
                                     backend="pallas", interpret=True))
    np.testing.assert_array_equal(got, want)


def test_route_pack_pallas_spreads_non_finite_rows():
    """The JAX Pallas backend's one-hot product spreads a NaN row over its
    128-slot block and turns -0.0 into +0.0; the port's route_pack keeps
    each value in its own slot (ROADMAP Queue 3)."""
    rows = np.ones((4, 3), np.float32)
    rows[1, 0] = np.nan
    rows[2, 1] = -0.0
    dst, ok = np.zeros(4, np.int64), np.ones(4, bool)
    order, _, slot_s, _, starts = ops.route_plan(
        torch.as_tensor(dst), torch.as_tensor(ok), 2, 4)
    got = ops.route_pack(torch.as_tensor(rows), order, slot_s, starts, 2,
                         4).numpy()
    assert np.isnan(got).sum() == 1 and np.signbit(got[2, 1])
    j_order, _, j_slot, _ = _jax_plan(dst, ok, 2, 4)
    pallas = np.asarray(jax_route_pack(jnp.asarray(rows)[j_order],
                                       jnp.asarray(j_slot), 8,
                                       backend="pallas", interpret=True))
    assert np.isnan(pallas).sum() > 1 and not np.signbit(pallas[2, 1])


# --------------------------------------------------------------- wire

def _msg(rng, C=13, d=5):
    part = rng.integers(0, 7, C)
    slot = rng.integers(0, 31, C)
    vec = rng.normal(size=(C, d)).astype(np.float32)
    cnt = rng.random(C).astype(np.float32)
    src = rng.integers(0, 7, C)
    valid = rng.random(C) < 0.6
    port = MsgBatch(part=torch.as_tensor(part), slot=torch.as_tensor(slot),
                    vec=torch.as_tensor(vec), cnt=torch.as_tensor(cnt),
                    src_part=torch.as_tensor(src),
                    valid=torch.as_tensor(valid))
    jx = JaxMsgBatch(part=jnp.asarray(part, jnp.int32),
                     slot=jnp.asarray(slot, jnp.int32), vec=jnp.asarray(vec),
                     cnt=jnp.asarray(cnt),
                     src_part=jnp.asarray(src, jnp.int32),
                     valid=jnp.asarray(valid))
    return port, jx


def _feat(rng, C=9, d=4):
    part = rng.integers(0, 2 ** 23, C)
    slot = rng.integers(0, 2 ** 23, C)
    feat = rng.normal(size=(C, d)).astype(np.float32)
    valid = rng.random(C) < 0.5
    port = FeatBatch(part=torch.as_tensor(part), slot=torch.as_tensor(slot),
                     feat=torch.as_tensor(feat),
                     valid=torch.as_tensor(valid))
    jx = JaxFeatBatch(part=jnp.asarray(part, jnp.int32),
                      slot=jnp.asarray(slot, jnp.int32),
                      feat=jnp.asarray(feat), valid=jnp.asarray(valid))
    return port, jx


def _assert_batch_equal(a, b):
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("make", [_msg, _feat], ids=["MsgBatch", "FeatBatch"])
def test_wire_pack_unpack_round_trip_against_jax(make):
    rng = np.random.default_rng(0)
    port, jx = make(rng)
    buf = wire.pack_lane(port)
    want = np.asarray(jax_wire.pack_lane(jx))
    assert wire.lane_width(port) == jax_wire.lane_width(jx) == buf.shape[1]
    np.testing.assert_array_equal(buf.numpy().view(np.int32),
                                  want.view(np.int32))
    for name in ("part", "slot", "valid"):
        assert wire.field_col(port, name) == jax_wire.field_col(jx, name)
    _assert_batch_equal(wire.unpack_lane(buf, port), port)
    back = jax_wire.unpack_lane(jnp.asarray(buf.numpy()), jx)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jx)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # through the plain route_pack: every live row arrives exactly (ints
    # below 2**24 included), at the slot of its destination bucket
    D, cap = 3, buf.shape[0]
    dst = port.part % D
    order, ship, slot_s, _, starts = ops.route_plan(dst, port.valid, D, cap)
    sent = wire.unpack_lane(
        ops.route_pack(buf, order, slot_s, starts, D, cap), port)
    live = slot_s[ship]
    moved = wire.unpack_lane(buf[order[ship]], port)
    for name in port.__dataclass_fields__:
        assert torch.equal(getattr(sent, name)[live],
                           getattr(moved, name)), name
    assert not sent.valid[~torch.isin(torch.arange(D * cap), live)].any()


def test_local_router_route_lanes_identity():
    rng = np.random.default_rng(3)
    msg, _ = _msg(rng)
    ring = wire.init_defer(0, wire.lane_width(msg), "cpu")
    lanes, defers, rcpt = LocalRouter(n_parts=4).route_lanes((msg,), (ring,))
    assert lanes[0] is msg and defers[0] is ring
    assert int(rcpt.rows) == int(rcpt.deferred) == int(rcpt.dropped) == 0
