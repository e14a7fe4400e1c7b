"""The port's routing-plane pieces against the JAX package, on the CPU:
`kernels/route_pack` (route_plan, the plain route_pack and route_lane
the wrappers run for CPU tensors), the packed wire format
(`dist/wire.py`) and the routers' route_lanes.

Tolerances: all exact. route_plan's order, masks and slots equal JAX's;
the plain route_pack equals JAX's "xla" backend bit for bit (int32 views,
NaN payloads, Inf and -0.0 included) and the Pallas backend (interpret
mode) value for value on finite rows; packed rows and their round trips
equal JAX's exactly. The fused lane step (route_lane_ref) equals the
router's earlier chain (pack_lane, cat, route_pack_ref, the ring's
cumsum / searchsorted gather) and JAX's route_lanes arithmetic bit for
bit, and a numpy replay of csrc/route_pack.cu's chunk, window and
ring-slot arithmetic gives the same words.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.events import FeatBatch as JaxFeatBatch
from repro.core.events import MsgBatch as JaxMsgBatch
from repro.dist import wire as jax_wire
from repro.serve.query import QueryBatch as JaxQueryBatch
from repro.kernels.route_pack import route_pack as jax_route_pack
from repro.kernels.route_pack import route_plan as jax_route_plan
from repro.kernels.route_pack import route_plan_ref as jax_route_plan_ref
from repro_torch.core.events import FeatBatch, MsgBatch
from repro_torch.dist import wire
from repro_torch.dist.router import LocalRouter, MeshRouter
from repro_torch.kernels.route_pack import ops, ref
from repro_torch.serve.query import QueryBatch


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


# ------------------------------------------------------ fused lane step

LANE_CASES = {
    # name: (batch, C, d, K, D, cap, live fraction, hub share)
    "msg-K0": ("msg", 50, 3, 0, 2, 4, 0.8, 0.5),
    "msg-ring": ("msg", 60, 5, 16, 4, 3, 0.8, 0.6),
    "msg-every-bucket-overflows": ("msg", 80, 4, 8, 4, 2, 1.0, 0.0),
    "msg-overflow-past-K": ("msg", 90, 2, 5, 2, 3, 1.0, 0.7),
    "msg-cap1": ("msg", 33, 6, 5, 2, 1, 0.9, 0.5),
    "msg-dense": ("msg", 40, 3, 12, 4, 52, 0.9, 0.5),
    "msg-W607": ("msg", 120, 602, 32, 4, 16, 0.8, 0.6),
    "feat-K0": ("feat", 45, 4, 0, 4, 3, 0.8, 0.5),
    "feat-ring": ("feat", 70, 7, 24, 4, 4, 0.9, 0.6),
    # the query plane's link-tail wire: 11 fields, int64 and bool read in
    # place; W = d + 10 (74 at the full width's d_out = 64)
    "query-K0": ("query", 48, 3, 0, 2, 5, 0.8, 0.5),
    "query-W32": ("query", 64, 22, 8, 4, 3, 0.9, 0.6),
    "query-W74-ring": ("query", 128, 64, 16, 4, 4, 0.9, 0.7),
}
N_PARTS = 8


def lane_inputs(name):
    """(port batch, JAX batch, ring rows [K, W], ring occupancy [K]) of a
    LANE_CASES case: NaN payloads, Inf and -0.0 in the float columns,
    slots >= 2**24 (they round on the wire, the same way everywhere) and
    parts outside [0, N_PARTS) on some rows."""
    kind, C, d, K, _, _, live, hub = LANE_CASES[name]
    rng = np.random.default_rng(len(name) * 7 + C)
    part = rng.integers(-1, N_PARTS + 1, C)
    part = np.where(rng.random(C) < hub, 0, part)
    slot = np.where(rng.random(C) < 0.5, rng.integers(2 ** 24, 2 ** 30, C),
                    rng.integers(0, 64, C))
    valid = rng.random(C) < live
    payload = special_rows(C + d, C, max(d, 1))[:, :d]
    if kind == "msg":
        cnt = special_rows(C + 1, C, 1)[:, 0]
        src = rng.integers(0, N_PARTS, C)
        port = MsgBatch(part=torch.as_tensor(part),
                        slot=torch.as_tensor(slot),
                        vec=torch.as_tensor(payload),
                        cnt=torch.as_tensor(cnt),
                        src_part=torch.as_tensor(src),
                        valid=torch.as_tensor(valid))
        jx = JaxMsgBatch(part=jnp.asarray(part, jnp.int32),
                         slot=jnp.asarray(slot, jnp.int32),
                         vec=jnp.asarray(payload), cnt=jnp.asarray(cnt),
                         src_part=jnp.asarray(src, jnp.int32),
                         valid=jnp.asarray(valid))
    elif kind == "query":
        cols = {"qid": rng.integers(0, 2 ** 24, C),
                "kind": rng.integers(0, 3, C), "part": part, "slot": slot,
                "part2": rng.integers(0, N_PARTS, C),
                "slot2": rng.integers(0, 2 ** 20, C),
                "consistent": rng.random(C) < 0.5,
                "ok": rng.random(C) < 0.7,
                "issue": rng.integers(0, 2 ** 24, C), "vec": payload,
                "valid": valid}
        port = QueryBatch(**{k: torch.as_tensor(v) for k, v in cols.items()})
        jx = JaxQueryBatch(**{k: jnp.asarray(
            v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in cols.items()})
    else:
        port = FeatBatch(part=torch.as_tensor(part),
                         slot=torch.as_tensor(slot),
                         feat=torch.as_tensor(payload),
                         valid=torch.as_tensor(valid))
        jx = JaxFeatBatch(part=jnp.asarray(part, jnp.int32),
                          slot=jnp.asarray(slot, jnp.int32),
                          feat=jnp.asarray(payload), valid=jnp.asarray(valid))
    W = wire.lane_width(port)
    # the ring carries packed rows of valid records (parts in range)
    ring = special_rows(K + W, K, W)
    ring[:, wire.field_col(port, "part")] = rng.integers(0, N_PARTS, K)
    occ = rng.random(K) < 0.7
    ring[~occ] = 0.0
    return port, jx, torch.as_tensor(ring), torch.as_tensor(occ)


def lane_plan(port, ring, occ, D, cap):
    """route_plan over the ring's rows then the lane's, as the router
    makes it."""
    fresh = port.valid & (port.part >= 0) & (port.part < N_PARTS)
    ok = torch.cat([occ, fresh])
    parts = torch.cat([ring[:, wire.field_col(port, "part")]
                       .to(torch.int64), port.part])
    dst = torch.where(ok, torch.div(parts, N_PARTS // D,
                                    rounding_mode="floor"), D)
    return ops.route_plan(dst, ok, D, cap), dst, ok


def parent_chain(ring, port, plan, D, cap):
    """The router's lane step as it ran before the fused kernel: pack the
    lane, concatenate the ring in front, place the sorted rows, gather
    the ring's refill with a cumsum / searchsorted."""
    order, _, slot_s, left_s, _ = plan
    K = ring.shape[0]
    packed = wire.pack_lane(port)
    allp = torch.cat([ring, packed]) if K else packed
    send = ref.route_pack_ref(allp[order], slot_s, D * cap)
    if not K:
        return send, ring
    n_left = left_s.sum()
    cum = torch.cumsum(left_s, 0)
    j = torch.arange(K)
    pos = torch.clamp(torch.searchsorted(cum, j + 1), max=cum.shape[0] - 1)
    nok = j < n_left
    return send, allp[order[pos]].masked_fill_(~nok[:, None], 0.0)


def _bits(t):
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_route_lane_ref_is_the_parent_chain_bit_for_bit(name):
    port, _, ring, occ = lane_inputs(name)
    _, _, _, K, D, cap, _, _ = LANE_CASES[name]
    plan, _, _ = lane_plan(port, ring, occ, D, cap)
    want = parent_chain(ring, port, plan, D, cap)
    ops.reset_launches()
    got = ops.route_lane(ring, port, plan, D, cap)
    assert ops.LAUNCHES == {"route_pack": 0, "route_lane": 0}, \
        "a CPU tensor ran the kernel"
    again = ref.route_lane_ref(ring, port, plan, D, cap)
    W = wire.lane_width(port)
    assert got[0].shape == (D * cap, W) and got[1].shape == (K, W)
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(a), _bits(w))
    if name.endswith(("overflows", "past-K")):
        assert int(plan[3].sum()) > K, "the case must overflow the ring"


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_route_lane_ref_equals_jax_route_lanes_arithmetic(name):
    """The send buffer and the new ring against JAX's MeshRouter body on
    the same rows: jax pack_lane, concatenate, route_plan, the "xla"
    route_pack, and the ring refill (the overflow's cumsum rank, kept
    below K, scattered into zeros)."""
    port, jx, ring, occ = lane_inputs(name)
    _, _, _, K, D, cap, _, _ = LANE_CASES[name]
    plan, dst, ok = lane_plan(port, ring, occ, D, cap)
    send, nbuf = ref.route_lane_ref(ring, port, plan, D, cap)
    packed = jax_wire.pack_lane(jx)
    allp = jnp.concatenate([jnp.asarray(ring.numpy()), packed]) if K \
        else packed
    order, ship_s, slot_s, left_s = jax_route_plan(
        jnp.asarray(dst.numpy(), jnp.int32), jnp.asarray(ok.numpy()), D, cap)
    rows_s = allp[order]
    want = jax_route_pack(rows_s, slot_s, D * cap, backend="xla")
    np.testing.assert_array_equal(_bits(send),
                                  np.asarray(want).view(np.int32))
    if K:
        lrank = jnp.cumsum(left_s.astype(jnp.int32)) - 1
        keep = left_s & (lrank < K)
        didx = jnp.where(keep, lrank, K)
        jbuf = jnp.zeros((K, allp.shape[1]), jnp.float32).at[didx].set(
            rows_s, mode="drop")
        jok = jnp.zeros((K,), bool).at[didx].set(True, mode="drop")
        np.testing.assert_array_equal(_bits(nbuf),
                                      np.asarray(jbuf).view(np.int32))
        np.testing.assert_array_equal(
            (torch.arange(K) < plan[3].sum()).numpy(), np.asarray(jok))


def replay_route_lane(order, starts, D, cap, W, K, chunk=512):
    """csrc/route_pack.cu's arithmetic in numpy: the output words of the
    send buffer [D * cap, W] then the new ring [K, W] as (source row,
    column) pairs, -1 for a zero word. Walks the kernel's flat chunks of
    `chunk` words: a 32-row window of sources at the chunk's first row
    (slid when a step's last lane passes it), the zero path of chunks
    with no sourced row, each lane's word q0 + 32 j + lane stepped by 32
    columns; the ring's slots located from starts by the running overflow
    and a binary search, as the kernel does."""
    n = starts[1:] - starts[:-1]
    ovf = np.concatenate([[0], np.cumsum(np.maximum(n - cap, 0))])

    def source(ring, row):
        if not ring:
            if row >= D * cap:
                return -1
            d, r = divmod(row, cap)
            return int(order[starts[d] + r]) if r < n[d] else -1
        if row >= K or row >= ovf[D]:
            return -1
        lo, hi = 0, D
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if ovf[mid] <= row else (lo, mid)
        return int(order[starts[lo] + cap + row - ovf[lo]])

    outs = []
    for ring, n_rows in ((False, D * cap), (True, K)):
        n_words = n_rows * W
        src = np.full(n_words, -2, np.int64)
        col = np.full(n_words, -2, np.int64)
        for q0 in range(0, n_words, chunk):
            q1 = min(q0 + chunk, n_words)
            row_last = (q1 - 1) // W
            wbase = q0 // W
            win = [source(ring, wbase + ln) if wbase + ln <= row_last else -1
                   for ln in range(32)]
            if row_last - wbase < 32 and max(win) < 0:
                src[q0:q1], col[q0:q1] = -1, -1
                continue
            rows = [(q0 + ln) // W for ln in range(32)]
            cols = [q0 + ln - rows[ln] * W for ln in range(32)]
            for j in range(chunk // 32):
                if j:
                    for ln in range(32):
                        cols[ln] += 32
                        if cols[ln] >= W:
                            wraps = 1 if W >= 32 else cols[ln] // W
                            rows[ln] += wraps
                            cols[ln] -= wraps * W
                if rows[31] - wbase >= 32:
                    wbase = rows[0]
                    win = [source(ring, wbase + ln)
                           if wbase + ln <= row_last else -1
                           for ln in range(32)]
                for ln in range(32):
                    q = q0 + 32 * j + ln
                    if q >= q1:
                        continue
                    assert 0 <= rows[ln] - wbase < 32
                    assert rows[ln] * W + cols[ln] == q
                    s = win[rows[ln] - wbase]
                    src[q], col[q] = (s, cols[ln]) if s >= 0 else (-1, -1)
        assert (src > -2).all(), "a word was never written"
        outs.append((src, col))
    return outs


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_kernel_arithmetic_replay_gives_the_plain_words(name):
    port, _, ring, occ = lane_inputs(name)
    _, _, _, K, D, cap, _, _ = LANE_CASES[name]
    plan, _, _ = lane_plan(port, ring, occ, D, cap)
    order, starts = plan[0].numpy(), plan[4].numpy()
    W = wire.lane_width(port)
    packed = wire.pack_lane(port)
    allp = (torch.cat([ring, packed]) if K else packed).numpy()
    want = ref.route_lane_ref(ring, port, plan, D, cap)
    for (src, col), w in zip(replay_route_lane(order, starts, D, cap, W, K),
                             want):
        got = np.where(src >= 0, allp.view(np.int32)[src, col], 0)
        np.testing.assert_array_equal(got.reshape(-1, W), _bits(w))


@pytest.mark.parametrize("W", [1, 5, 31, 69])
def test_kernel_ring_slot_location_is_the_fifo_overflow(W):
    """The kernel locates ring slot j from starts alone (running overflow,
    binary search); the plan's left_s marks the same sorted positions, in
    the same order, as JAX's cumsum rank keeps them."""
    rng = np.random.default_rng(W)
    N, D, cap, K = 300, 4, 7, 50
    dst = np.where(rng.random(N) < 0.5, 0, rng.integers(0, D + 1, N))
    ok = rng.random(N) < 0.8
    order, _, _, left_s, starts = _port_plan(dst, ok, D, cap)
    n = starts[1:] - starts[:-1]
    ovf = np.concatenate([[0], np.cumsum(np.maximum(n - cap, 0))])
    assert ovf[-1] == left_s.sum() > K
    where = np.flatnonzero(left_s)[:K]
    for j in range(K):
        d = int(np.searchsorted(ovf, j, side="right")) - 1
        assert n[d] > cap
        assert starts[d] + cap + j - ovf[d] == where[j]
    # and the replay's ring words come from those rows
    src, col = replay_route_lane(order, starts, D, cap, W, K)[1]
    np.testing.assert_array_equal(src.reshape(K, W)[:, 0], order[where])


def test_lane_fields_is_the_wire_layout():
    rng = np.random.default_rng(11)
    for port, _ in (_msg(rng), _feat(rng)):
        layout = wire.lane_fields(port)
        packed = wire.pack_lane(port)
        assert [n for n, _, _, _ in layout] == list(
            port.__dataclass_fields__)
        assert sum(w for _, _, _, w in layout) == wire.lane_width(port)
        for name, t, col, w in layout:
            assert wire.field_col(port, name) == col
            assert torch.equal(packed[:, col:col + w],
                               t.reshape(t.shape[0], w).to(torch.float32))


class _LoopbackMesh:
    """A two-rank StreamMesh stand-in on one process: all_to_all returns
    the send buffer (each rank hears itself), enough to drive
    MeshRouter.route_lanes' local work (a 1-D mesh: one stage)."""
    size, rank, n_stages = 2, 0, 1

    def all_to_all(self, buf):
        return buf.clone()

    def all_reduce(self, x):
        return x


@pytest.mark.parametrize("K", [0, 16])
def test_mesh_router_backends_take_one_lane_step_each(K, monkeypatch):
    """route_lanes hands each lane to ONE route_lane call (kernel backend)
    or to its plain chain (scatter), with the plan over the ring's parts
    then the lane's; both give the parent chain's rings and receipts."""
    port, _, ring, occ = lane_inputs("msg-ring")
    ring, occ = ring[:K], occ[:K]
    calls = []
    real = ops.route_lane

    def spy(r, lane, plan, D, cap):
        calls.append((r, lane, D, cap))
        return real(r, lane, plan, D, cap)

    monkeypatch.setattr(ops, "route_lane", spy)
    outs = {}
    for backend in ("kernel", "scatter"):
        router = MeshRouter(n_parts=N_PARTS, mesh=_LoopbackMesh(),
                            route_cap=5, pack_backend=backend)
        outs[backend] = router.route_lanes((port,), ((ring, occ),))
    assert len(calls) == 1 and calls[0][0] is ring and calls[0][1] is port
    assert calls[0][2:] == (2, 5)
    plan, _, _ = lane_plan(port, ring, occ, 2, 5)
    send, nbuf = parent_chain(ring, port, plan, 2, 5)
    n_left = int(plan[3].sum())
    for lanes, defers, rcpt in outs.values():
        got = wire.pack_lane(lanes[0])
        np.testing.assert_array_equal(
            _bits(got), _bits(wire.pack_lane(wire.unpack_lane(send, port))))
        np.testing.assert_array_equal(_bits(defers[0][0]), _bits(nbuf))
        assert torch.equal(defers[0][1], torch.arange(K) < n_left)
        assert int(rcpt.rows) == int(plan[1].sum())
        assert int(rcpt.deferred) == min(n_left, K)
        assert int(rcpt.dropped) == n_left - min(n_left, K)
