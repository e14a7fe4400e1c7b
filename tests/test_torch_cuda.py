"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without an NVIDIA GPU (the kernels build
with nvcc at first launch). This file imports neither jax nor the JAX
package, so it runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to their plain versions at the
models' shapes; these are the small cases.
"""
from dataclasses import dataclass, fields

import numpy as np
import pytest
import torch

from repro_torch.core.events import FeatBatch, MsgBatch
from repro_torch.dist import wire
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.route_pack import ops as rp_ops, ref as rp_ref
from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
from repro_torch.serve.query import QueryBatch

pytestmark = pytest.mark.cuda

# bf16: both round the output to bf16 (one ulp is 2^-7 relative); f32:
# sums in another order
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=1e-4, atol=2e-5)}
# segment kernel A vs its plain version (f32 index_add_): per element
# |diff| <= KA_TOL * (1 + the run's sum of magnitudes), the sums taken in
# another order (shares, carries); counts (small integers), flags and
# set-mode rows (copies) exactly equal
KA_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,H,Kh,D", [
    (2, 200, 200, 8, 2, 64),     # ragged, G = 4
    (1, 70, 130, 4, 4, 16),      # S < T
    (1, 129, 65, 2, 1, 128),     # S > T
])
def test_flash_attention_matches_plain(cuda, dtype, causal, B, S, T, H, Kh,
                                       D):
    rng = np.random.default_rng(S + T + D)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
               .to(cuda, dtype) for shape in ((B, S, H, D), (B, T, Kh, D),
                                              (B, T, Kh, D)))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


# the wgmma kernel (bf16, D 64 and 128): sizes at and around its 128-row
# query and key tiles, S < T and S > T, against the plain version
WGMMA_ST = [(1, 1), (127, 127), (128, 128), (129, 129), (383, 383),
            (127, 383), (383, 129), (1, 128), (129, 1)]


def _bf16(rng, shape, cuda):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        cuda, torch.bfloat16)


@pytest.mark.parametrize("S,T", WGMMA_ST)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_matches_plain(cuda, D, causal, G, S, T):
    B, Kh = 2, 2
    rng = np.random.default_rng(S * 1000 + T + D + G)
    q = _bf16(rng, (B, S, G * Kh, D), cuda)
    k, v = _bf16(rng, (B, T, Kh, D), cuda), _bf16(rng, (B, T, Kh, D), cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 1}
    want = ref.attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_reads_strided_views_of_fused_qkv(cuda, D, causal):
    """q, k, v as views of one [B, S, H + 2 Kh, D] tensor: tensor maps
    with a head stride of D and a row stride of (H + 2 Kh) D."""
    B, S, H, Kh = 2, 190, 8, 2
    qkv = _bf16(np.random.default_rng(D), (B, S, H + 2 * Kh, D), cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Kh], qkv[:, :, H + Kh:]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


def test_flash_wgmma_reads_kv_broadcast_over_heads(cuda):
    """k/v expanded over their heads (head stride 0): the tensor map
    steps nowhere along that dim."""
    rng = np.random.default_rng(11)
    q = _bf16(rng, (2, 300, 8, 128), cuda)
    k = _bf16(rng, (2, 300, 1, 128), cuda).expand(2, 300, 2, 128)
    v = _bf16(rng, (2, 300, 1, 128), cuda).expand(2, 300, 2, 128)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("D,wgmma", [(128, 1), (64, 1), (32, 0), (16, 0)])
def test_flash_launch_counts_name_the_kernel(cuda, D, wgmma):
    q = torch.zeros(1, 64, 4, D, device=cuda, dtype=torch.bfloat16)
    ops.reset_launches()
    ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    assert ops.LAUNCHES == {"flash_attention": 1,
                            "flash_attention_wgmma": wgmma}


def test_flash_mma_sync_yardstick_matches_plain_and_counts_nothing(cuda):
    rng = np.random.default_rng(7)
    q = _bf16(rng, (1, 200, 8, 128), cuda)
    k, v = _bf16(rng, (1, 200, 2, 128), cuda), _bf16(rng, (1, 200, 2, 128),
                                                     cuda)
    ops.reset_launches()
    got = ops._flash_attention_mma_sync(q, k, v, causal=True)
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0}
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.attention_ref(q, k, v, causal=True).float().cpu().numpy(),
        **TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,G", [(70, 70, 4), (33, 100, 1), (129, 65, 2)])
def test_flash_f32_at_head_dim_8_matches_plain(cuda, causal, S, T, G):
    """f32 at D = 8, the reduced internlm2-20b and mistral-large-123b
    configs' head dim (the CUDA-core kernel only)."""
    rng = np.random.default_rng(S + T + G)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
               .to(cuda) for shape in ((2, S, 2 * G, 8), (2, T, 2, 8),
                                       (2, T, 2, 8)))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 0}
    np.testing.assert_allclose(got.cpu().numpy(), ref.attention_ref(
        q, k, v, causal=causal).cpu().numpy(), **TOL[torch.float32])


def test_flash_attention_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 8, 4, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 8, 4, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("B,W,d", [
    (100, 8, 256),     # B no multiple of 64, the model's width
    (37, 3, 30),       # d % 4 != 0: one float per lane
    (64, 40, 16),      # W > 32: two groups of ids
    (5, 1, 512),       # two column passes
])
def test_embedding_bag_matches_plain(cuda, mode, id_dtype, B, W, d):
    rng = np.random.default_rng(B + W + d)
    V = 300
    table = torch.as_tensor(rng.normal(size=(V, d)).astype(np.float32),
                            device=cuda)
    ids = rng.integers(-3, V, (B, W))
    ids[1] = -1                        # an all-padding bag
    ids[2, 0] = V                      # an id past the table: a NaN bag
    ids = torch.as_tensor(ids, device=cuda, dtype=id_dtype)
    eb_ops.reset_launches()
    got = eb_ops.embedding_bag(table, ids, mode)
    assert eb_ops.LAUNCHES["embedding_bag"] == 1
    want = eb_ref.embedding_bag_ref(table, ids, mode)
    # f32 sums of at most W rows in another order: |diff| <= 1e-6 (1 +
    # sum_i |w_i row_i|)
    mag = eb_ref.embedding_bag_ref(table.abs(), ids, mode)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    err = (got - want).abs().masked_fill(nan, 0.0)
    assert bool((err <= 1e-6 * (1 + mag.masked_fill(nan, 0.0))).all()), \
        float(err.max())
    assert bool(got[2].isnan().all()) and bool((got[1] == 0).all())
    assert int(got.isnan().any(dim=1).sum()) == 1


def test_embedding_bag_raises_on_what_it_does_not_take(cuda):
    table = torch.zeros(10, 8, device=cuda, dtype=torch.bfloat16)
    ids = torch.zeros(4, 2, device=cuda, dtype=torch.int64)
    with pytest.raises(ValueError, match="f32 table"):
        eb_ops.embedding_bag(table, ids, "sum")
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag(table.float().t(), ids, "sum")
    with pytest.raises(ValueError, match="on cpu"):
        eb_ops.embedding_bag(table.float(), ids.cpu(), "sum")
    out = eb_ops.embedding_bag(table.float(), ids[:0], "mean")
    assert out.shape == (0, 8)


# route_pack: the kernel's send buffer equals its plain version bit for
# bit (int32 views), NaN payloads, Inf and -0.0 included
@pytest.mark.parametrize("N,D,cap,W,live,hub", [
    (0, 4, 3, 5, 1.0, False),        # nothing to send
    (300, 4, 5, 69, 0.0, True),      # every row dropped
    (400, 4, 8, 69, 1.0, False),     # every bucket overflows
    (77, 2, 1, 5, 0.9, True),        # cap = 1
    (64, 4, 64, 12, 1.0, False),     # dense: cap = N
    (1000, 2, 64, 1, 0.7, True),
    (1000, 4, 64, 607, 0.7, True),
])
def test_route_pack_matches_plain_bit_for_bit(cuda, N, D, cap, W, live, hub):
    rng = np.random.default_rng(N + W)
    rows = rng.normal(size=(N, W)).astype(np.float32)
    flat = rows.view(np.int32).reshape(-1)
    if flat.size:
        spots = rng.choice(flat.size, size=min(6, flat.size), replace=False)
        flat[spots] = np.array([0x7FC00000, 0x7F800001, 0x7F800000,
                                0xFF800000, 0x80000000, 0xFFC01234],
                               np.uint32).view(np.int32)[:len(spots)]
    dst = np.where(rng.random(N) < 0.75, 0, rng.integers(0, D, N)) if hub \
        else rng.integers(0, D, N)
    ok = rng.random(N) < live
    rows = torch.as_tensor(rows, device=cuda)
    plan = rp_ops.route_plan(torch.as_tensor(dst, device=cuda),
                             torch.as_tensor(ok, device=cuda), D, cap)
    order, _, slot_s, _, starts = plan
    rp_ops.reset_launches()
    got = rp_ops.route_pack(rows, order, slot_s, starts, D, cap)
    want = rp_ref.route_pack_ref(rows[order], slot_s, D * cap)
    assert rp_ops.LAUNCHES["route_pack"] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_route_pack_raises_on_what_it_does_not_take(cuda):
    rows = torch.zeros(4, 3, device=cuda)
    dst = torch.zeros(4, dtype=torch.int64, device=cuda)
    order, _, slot_s, _, starts = rp_ops.route_plan(
        dst, torch.ones(4, dtype=torch.bool, device=cuda), 2, 2)
    with pytest.raises(ValueError, match="float32"):
        rp_ops.route_pack(rows.double(), order, slot_s, starts, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rp_ops.route_pack(rows.t().contiguous().t(), order, slot_s, starts,
                          2, 2)
    with pytest.raises(ValueError, match="plan for"):
        rp_ops.route_pack(rows, order, slot_s, starts, 3, 2)


# route_lane: the fused lane step (ring rows, then the lane's fields read
# in place) against its plain chain, bit for bit (int32 views)
@dataclass(frozen=True)
class PartLane:
    """A one-column lane (W = 1)."""
    part: torch.Tensor


_SPECIALS = np.array([0x7FC00000, 0x7F800001, 0x7F800000, 0xFF800000,
                      0x80000000, 0xFFC01234], np.uint32).view(np.int32)


def _special(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1).view(np.int32)
    if flat.size:
        spots = rng.choice(flat.size, size=min(6, flat.size), replace=False)
        flat[spots] = _SPECIALS[:len(spots)]
    return torch.as_tensor(x)


def _lane(rng, kind, C, d, n_parts):
    part = torch.as_tensor(np.where(rng.random(C) < 0.6, 0,
                                    rng.integers(-1, n_parts + 1, C)))
    if kind == "part":
        return PartLane(part=part)
    # slots >= 2**24 round on the wire, the same way in kernel and chain
    slot = torch.as_tensor(rng.integers(0, 2 ** 40, C))
    valid = torch.as_tensor(rng.random(C) < 0.8)
    if kind == "feat":
        return FeatBatch(part=part, slot=slot, feat=_special(rng, (C, d)),
                         valid=valid)
    if kind == "query":         # 11 fields: int64, bool and f32
        ints = lambda hi: torch.as_tensor(rng.integers(0, hi, C))
        bools = lambda: torch.as_tensor(rng.random(C) < 0.5)
        return QueryBatch(qid=ints(2 ** 24), kind=ints(3), part=part,
                          slot=slot, part2=ints(n_parts), slot2=ints(2 ** 30),
                          consistent=bools(), ok=bools(), issue=ints(2 ** 24),
                          vec=_special(rng, (C, d)), valid=valid)
    return MsgBatch(part=part, slot=slot, vec=_special(rng, (C, d)),
                    cnt=_special(rng, (C,)),
                    src_part=torch.as_tensor(rng.integers(0, n_parts, C)),
                    valid=valid)


def _lane_case(cuda, kind, C, d, K, D, cap, seed, n_parts=8):
    """(ring [K, W], lane, plan) on the card, the plan made as the router
    makes it (ring parts, then the lane's; live = valid and in range)."""
    rng = np.random.default_rng(seed)
    lane = _lane(rng, kind, C, d, n_parts)
    lane = type(lane)(**{f.name: getattr(lane, f.name).to(cuda)
                         for f in fields(lane)})
    W = wire.lane_width(lane)
    ring = _special(rng, (K, W)).to(cuda)
    ring[:, 0] = torch.as_tensor(rng.integers(0, n_parts, K),
                                 dtype=torch.float32, device=cuda)
    occ = torch.as_tensor(rng.random(K) < 0.7, device=cuda)
    live = (lane.part >= 0) & (lane.part < n_parts)
    if kind != "part":
        live &= lane.valid
    ok = torch.cat([occ, live])
    parts = torch.cat([ring[:, 0].to(torch.int64), lane.part])
    dst = torch.where(ok, torch.div(parts, n_parts // D,
                                    rounding_mode="floor"), D)
    return ring, lane, rp_ops.route_plan(dst, ok, D, cap)


@pytest.mark.parametrize("kind,d", [("part", 0), ("msg", 0), ("msg", 64),
                                    ("msg", 602), ("feat", 5), ("query", 3),
                                    ("query", 64)],
                         ids=["W1", "W5", "W69", "W607", "feat-W8",
                              "query-W13", "query-W74"])
@pytest.mark.parametrize("C,K,D,cap", [
    (300, 0, 4, 16),         # no ring
    (300, 40, 4, 16),        # ring in front
    (400, 8, 4, 2),          # every bucket overflows, past the ring
    (77, 5, 2, 1),           # cap = 1
    (120, 30, 4, 150),       # dense: nothing overflows
    (0, 12, 2, 3),           # ring rows only
])
def test_route_lane_matches_plain_bit_for_bit(cuda, kind, d, C, K, D, cap):
    ring, lane, plan = _lane_case(cuda, kind, C, d, K, D, cap,
                                  C + 7 * K + d + cap)
    rp_ops.reset_launches()
    send, nbuf = rp_ops.route_lane(ring, lane, plan, D, cap)
    torch.cuda.synchronize()
    assert rp_ops.LAUNCHES == {"route_pack": 0, "route_lane": 1}
    want_send, want_ring = rp_ref.route_lane_ref(ring, lane, plan, D, cap)
    assert send.shape == want_send.shape and nbuf.shape == ring.shape
    assert torch.equal(send.view(torch.int32), want_send.view(torch.int32))
    assert torch.equal(nbuf.view(torch.int32), want_ring.view(torch.int32))


def test_route_lane_reads_strided_fields_in_place(cuda):
    """Fields as column views of wider tensors (row stride > width)."""
    ring, lane, plan = _lane_case(cuda, "msg", 500, 64, 20, 4, 8, 3)
    wide = torch.zeros(500, 70, device=cuda)
    wide[:, 3:67] = lane.vec
    cols = torch.zeros(500, 2, dtype=torch.int64, device=cuda)
    cols[:, 1] = lane.slot
    lane = MsgBatch(part=lane.part, slot=cols[:, 1], vec=wide[:, 3:67],
                    cnt=lane.cnt, src_part=lane.src_part, valid=lane.valid)
    got = rp_ops.route_lane(ring, lane, plan, 4, 8)
    want = rp_ref.route_lane_ref(ring, lane, plan, 4, 8)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_route_lane_raises_on_what_it_does_not_take(cuda):
    ring, lane, plan = _lane_case(cuda, "msg", 40, 3, 6, 2, 4, 1)
    with pytest.raises(ValueError, match="float32"):
        rp_ops.route_lane(ring.double(), lane, plan, 2, 4)
    with pytest.raises(ValueError, match="wide"):
        rp_ops.route_lane(ring[:, :-1].contiguous(), lane, plan, 2, 4)
    with pytest.raises(ValueError, match="plan for"):
        rp_ops.route_lane(ring[:3].contiguous(), lane, plan, 2, 4)
    bad = MsgBatch(part=lane.part, slot=lane.slot.int(), vec=lane.vec,
                   cnt=lane.cnt, src_part=lane.src_part, valid=lane.valid)
    with pytest.raises(ValueError, match="the wire takes"):
        rp_ops.route_lane(ring, bad, plan, 2, 4)
    bad = MsgBatch(part=lane.part, slot=lane.slot, vec=lane.vec.cpu(),
                   cnt=lane.cnt, src_part=lane.src_part, valid=lane.valid)
    with pytest.raises(ValueError, match="on cpu"):
        rp_ops.route_lane(ring, bad, plan, 2, 4)
    bad = MsgBatch(part=lane.part, slot=lane.slot,
                   vec=lane.vec.t().contiguous().t(), cnt=lane.cnt,
                   src_part=lane.src_part, valid=lane.valid)
    with pytest.raises(ValueError, match="contiguous rows"):
        rp_ops.route_lane(ring, bad, plan, 2, 4)
    with pytest.raises(ValueError, match="on cpu"):
        rp_ops.route_lane(ring, lane, (plan[0].cpu(),) + plan[1:], 2, 4)


# segment kernel B (fused gather + mean read) against its plain version:
# the same IEEE division, so equal bit for bit; cnt <= 0 rows read 0
@pytest.mark.parametrize("d", [1, 3, 64, 602, 1601])
@pytest.mark.parametrize("K", [0, 1, 33, 8192])
def test_mean_rows_gather_matches_plain(cuda, d, K):
    rng = np.random.default_rng(d * 31 + K)
    R = 3000
    agg = torch.as_tensor(rng.normal(size=(R, d)).astype(np.float32),
                          device=cuda)
    cnt = torch.as_tensor(rng.integers(-2, 6, R).astype(np.float32),
                          device=cuda)
    rows = torch.as_tensor(np.where(rng.random(K) < 0.2, 5,
                                    rng.integers(0, R, K)), device=cuda)
    sr_ops.reset_launches()
    got = sr_ops.mean_rows_gather(agg, cnt, rows)
    torch.cuda.synchronize()
    assert sr_ops.LAUNCHES["mean_rows_gather"] == (K > 0)
    want = sr_ref.mean_rows_gather_ref(agg, cnt, rows)
    assert got.shape == (K, d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[cnt[rows] <= 0] == 0).all())


def test_mean_rows_gather_reads_rows_aligned_to_four_bytes_only(cuda):
    """A table one float into its storage (rows 4-byte aligned only) runs
    at vector width 1 and gives the plain version's result."""
    rng = np.random.default_rng(5)
    R, d, K = 700, 64, 500
    flat = torch.as_tensor(rng.normal(size=R * d + 1).astype(np.float32),
                           device=cuda)
    cnt = torch.as_tensor(rng.integers(-1, 4, R).astype(np.float32),
                          device=cuda)
    rows = torch.as_tensor(rng.integers(0, R, K), device=cuda)
    agg = flat[1:].view(R, d)
    assert agg.data_ptr() % 16 == 4
    got = sr_ops.mean_rows_gather(agg, cnt, rows)
    want = sr_ref.mean_rows_gather_ref(agg, cnt, rows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_mean_rows_gather_raises_on_what_it_does_not_take(cuda):
    agg = torch.zeros(6, 4, device=cuda)
    cnt = torch.ones(6, device=cuda)
    rows = torch.tensor([0, 5, 2], device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sr_ops.mean_rows_gather(agg.double(), cnt, rows)
    with pytest.raises(ValueError, match="int64"):
        sr_ops.mean_rows_gather(agg, cnt, rows.int())
    with pytest.raises(ValueError, match="on cpu"):
        sr_ops.mean_rows_gather(agg, cnt.cpu(), rows)
    with pytest.raises(ValueError, match="agg must be contiguous"):
        sr_ops.mean_rows_gather(torch.zeros(4, 6, device=cuda).t(), cnt,
                                rows)
    with pytest.raises(ValueError, match="agg must be contiguous"):
        sr_ops.mean_rows_gather(torch.zeros(6, 9, device=cuda)[:, :4], cnt,
                                rows)
    with pytest.raises(ValueError, match="cnt must be contiguous"):
        sr_ops.mean_rows_gather(agg, torch.ones(12, device=cuda)[::2], rows)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        sr_ops.mean_rows_gather(agg, cnt, torch.zeros(
            6, dtype=torch.int64, device=cuda)[::2])
    with pytest.raises(ValueError, match="cnt has"):
        sr_ops.mean_rows_gather(agg, cnt[:5], rows)


# segment kernel A (gather-form delivery) against its plain version
def _sorted_runs(cuda, n, C, d, hub, drop, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(n, 1), C)
    if hub is not None:
        idx[rng.random(C) < 0.7] = hub
    gone = rng.random(C) < drop
    idx[gone] = rng.choice([-1, n, n + 5], int(gone.sum()))
    vec = torch.as_tensor(rng.normal(size=(C, d)).astype(np.float32),
                          device=cuda)
    cnt = torch.as_tensor(rng.integers(-1, 3, C).astype(np.float32),
                          device=cuda)
    base = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                           device=cuda)
    base_cnt = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                               device=cuda)
    order, row_ptr = sr_ops.sort_runs(torch.as_tensor(idx, device=cuda), n)
    return vec, cnt, base, base_cnt, order, row_ptr


def _assert_deliver_matches_plain(args, kw, mode):
    vec, cnt, base, base_cnt, order, row_ptr = args
    sr_ops.reset_launches()
    got = sr_ops.deliver_rows(vec, row_ptr, mode=mode, **kw)
    torch.cuda.synchronize()
    assert sr_ops.LAUNCHES["segment_sum_rows"] == (row_ptr.numel() > 1)
    want = sr_ref.deliver_rows_ref(vec, row_ptr, mode=mode, **kw)
    assert torch.equal(got[2], want[2])
    if kw.get("cnt") is not None:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None
    if mode == "set":
        assert torch.equal(got[0], want[0])
        return
    absum = sr_ref.deliver_rows_ref(
        vec.abs(), row_ptr, mode=mode, order=kw.get("order"),
        base=None if kw.get("base") is None else kw["base"].abs())[0]
    err = (got[0] - want[0]).abs()
    assert bool((err <= KA_TOL * (1 + absum)).all()), float(err.max())
    again = sr_ops.deliver_rows(vec, row_ptr, mode=mode, **kw)
    assert torch.equal(again[0], got[0])          # no atomics


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("with_order", [True, False])
@pytest.mark.parametrize("n,C,d,hub,drop", [
    (40, 300, 1, None, 0.3),
    (40, 300, 3, 5, 0.3),
    (500, 4000, 64, 0, 0.4),
    (200, 3000, 602, 7, 0.3),
    (50, 20000, 70, 3, 0.0),       # a hub run over many CTAs
    (30, 300, 5, None, 1.0),       # all padding
    (0, 10, 4, None, 0.0),         # n_rows = 0
    (1, 50, 3, None, 0.2),         # n_rows = 1
])
def test_deliver_rows_matches_plain(cuda, mode, with_base, with_order, n, C,
                                    d, hub, drop):
    vec, cnt, base, base_cnt, order, row_ptr = _sorted_runs(
        cuda, n, C, d, hub, drop, n * 31 + C + d)
    if not with_order:                 # the contiguous form: sorted rows
        vec, cnt, order = vec[order], cnt[order], None
    kw = dict(order=order, cnt=cnt)
    if with_base:
        kw.update(base=base, base_cnt=base_cnt)
    _assert_deliver_matches_plain((vec, cnt, base, base_cnt, order,
                                   row_ptr), kw, mode)


@pytest.mark.parametrize("mode", ["add", "set"])
def test_deliver_rows_reads_strided_wire_columns_and_wide_rows(cuda, mode):
    """vec and cnt as column views of a packed wire buffer (row stride W,
    rows 4-byte aligned only), and d = 1601 (several column tiles)."""
    for n, C, d, W in ((300, 5000, 602, 607), (60, 900, 1601, 1601)):
        vec, cnt, base, base_cnt, order, row_ptr = _sorted_runs(
            cuda, n, C, d, 3, 0.3, d)
        wire = torch.zeros(C, W + 2, device=cuda)
        wire[:, 1:d + 1], wire[:, d + 1] = vec, cnt
        vec, cnt = wire[:, 1:d + 1], wire[:, d + 1]
        _assert_deliver_matches_plain(
            (vec, cnt, base, base_cnt, order, row_ptr),
            dict(order=order, cnt=cnt, base=base, base_cnt=base_cnt), mode)


def test_segment_sum_rows_matches_plain(cuda):
    vec, _, _, _, order, row_ptr = _sorted_runs(cuda, 300, 6000, 604, 2,
                                                0.5, 1)
    rows = vec[order]
    seg = torch.repeat_interleave(
        torch.arange(300, device=cuda), row_ptr.diff(),
        output_size=int(row_ptr[-1]))
    seg = torch.cat([seg, torch.full((6000 - seg.numel(),), 300,
                                     device=cuda)])
    got = sr_ops.segment_sum_rows(rows, seg, row_ptr)
    want = sr_ref.segment_sum_rows_ref(rows, seg, row_ptr)
    absum = sr_ref.segment_sum_rows_ref(rows.abs(), seg, row_ptr)
    assert bool(((got - want).abs() <= KA_TOL * (1 + absum)).all())


def test_deliver_rows_raises_on_what_it_does_not_take(cuda):
    vec = torch.zeros(6, 3, device=cuda)
    row_ptr = torch.tensor([0, 2, 6], device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sr_ops.deliver_rows(vec.double(), row_ptr)
    with pytest.raises(ValueError, match="on cpu"):
        sr_ops.deliver_rows(vec, row_ptr.cpu())
    with pytest.raises(ValueError, match="contiguous rows"):
        sr_ops.deliver_rows(torch.zeros(3, 6, device=cuda).t(), row_ptr)
    with pytest.raises(ValueError, match="contiguous"):
        sr_ops.deliver_rows(vec, row_ptr, order=torch.zeros(
            12, dtype=torch.int64, device=cuda)[::2])
    with pytest.raises(ValueError, match="base is"):
        sr_ops.deliver_rows(vec, row_ptr, base=torch.zeros(3, 3,
                                                           device=cuda))
    with pytest.raises(ValueError, match="int64"):
        sr_ops.deliver_rows(vec, row_ptr.int())


# the query plane on the card against the CPU, at tests/test_query_plane.py's
# golden sizes (32 nodes, dims (8, 12, 12), 4 parts) and query mix: qid,
# kind, ok, tick and issue exactly equal; vec and score within 1e-5 x
# (1 + |cpu|) (f32 sums of the same records in another order)
def _golden_stream(seed=0, n_edges=100, n_nodes=32, d_in=8):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n_nodes, n_edges),
                      rng.integers(0, n_nodes, n_edges)], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = {v: rng.normal(size=d_in).astype(np.float32)
             for v in range(n_nodes)}
    return edges, feats


def _serve_golden(device, driver, backend):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = _golden_stream()
    cfg = PipelineConfig(n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
                         feat_cap=128, edge_tick_cap=32, max_nodes=32,
                         query_cap=8, delivery_backend=backend,
                         window=win.WindowConfig(kind=win.STREAMING))
    pipe = D3Pipeline(GraphSAGE((8, 12, 12), seed=0), cfg, device=device)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    u, v = int(edges[0, 0]), int(edges[0, 1])
    q = [(1, 0, 0, False), (2, 1, u, v, True), (3, 0, 5, True),
         (4, 1, u, 5, False)]
    if driver == "tick":
        for i, (ch, fe) in enumerate(zip(e_chunks, f_chunks)):
            pipe.tick(ch, fe, queries=q if i == len(e_chunks) - 1 else None)
        pipe.flush(max_ticks=96)
    else:
        pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks),
                            query_chunks=[None] * (len(e_chunks) - 1) + [q])
        pipe.flush_super(max_ticks=96, T=4)
    ans = pipe.drain_answers()
    order = np.argsort(ans["qid"])
    return {k: a[order] for k, a in ans.items()}


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_query_plane_on_the_card_matches_the_cpu(cuda, driver, backend):
    torch.backends.cuda.matmul.allow_tf32 = False
    rp_ops.reset_launches()
    sr_ops.reset_launches()
    got = _serve_golden(cuda, driver, backend)
    want = _serve_golden(torch.device("cpu"), driver, backend)
    assert got["qid"].tolist() == [1, 2, 3, 4] and got["ok"].all()
    for k in ("qid", "kind", "ok", "tick", "issue"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("vec", "score"):
        assert (np.abs(got[k] - want[k])
                <= 1e-5 * (1 + np.abs(want[k]))).all(), k
    if backend == "kernel":
        assert sr_ops.LAUNCHES["segment_sum_rows"] > 0
        assert sr_ops.LAUNCHES["mean_rows_gather"] > 0


# kernel A at the training plane's and the gated tick's call sites: the
# backward's edge fold (no base, no counts), its replica fold (a base, no
# counts) and replica zeroing (a stride-0 row of zeros, set mode), and the
# coalescer, card against the plain version / the CPU
@pytest.mark.parametrize("d", [64, 602])
def test_delivery_at_the_backward_call_sites(cuda, d):
    from repro_torch.core.delivery import KernelDelivery
    kd = KernelDelivery()
    n, C = 500, 6000
    vec, _, base, _, _, _ = _sorted_runs(cuda, n, C, d, 7, 0.3, d)
    rng = np.random.default_rng(d)
    idx = rng.integers(0, n, C)
    idx[rng.random(C) < 0.6] = 3
    idx[rng.random(C) < 0.3] = n                  # dropped records
    idx = torch.as_tensor(idx, device=cuda)
    sr_ops.reset_launches()
    got, cnt = kd.add_rows(n, idx, vec)
    order, row_ptr = sr_ops.sort_runs(idx, n)
    want = sr_ref.deliver_rows_ref(vec, row_ptr, order)[0]
    absum = sr_ref.deliver_rows_ref(vec.abs(), row_ptr, order)[0]
    assert cnt is None and sr_ops.LAUNCHES["segment_sum_rows"] == 1
    assert bool(((got - want).abs() <= KA_TOL * (1 + absum)).all())
    got, none, flag = kd.deliver_add(base, None, idx, vec, None)
    want = sr_ref.deliver_rows_ref(vec, row_ptr, order, base=base)
    assert none is None and torch.equal(flag, want[2])
    absum = sr_ref.deliver_rows_ref(vec.abs(), row_ptr, order,
                                    base=base.abs())[0]
    assert bool(((got - want[0]).abs() <= KA_TOL * (1 + absum)).all())
    zeros = base.new_zeros((1, d)).expand(C, d)
    got, touched = kd.deliver_set(base, idx, zeros)
    want = base.clone()
    want[idx[idx < n]] = 0.0
    assert torch.equal(got, want) and int(touched.sum()) == int(
        torch.unique(idx[idx < n]).numel())


@pytest.mark.parametrize("live", [0.0, 0.7, 1.0])
def test_coalescer_on_the_card_matches_the_cpu(cuda, live):
    from repro_torch.core.delivery import KernelDelivery
    from repro_torch.core.events import coalesce_msg_batch
    rng = np.random.default_rng(int(live * 10))
    C, n_parts, n_slots, d = 20000, 8, 64, 602
    cols = dict(part=rng.integers(0, n_parts, C),
                slot=np.where(rng.random(C) < 0.5, 0,
                              rng.integers(0, n_slots, C)),
                vec=rng.normal(size=(C, d)).astype(np.float32),
                cnt=rng.integers(-1, 2, C).astype(np.float32),
                src_part=rng.integers(0, n_parts, C),
                valid=rng.random(C) < live)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        b = MsgBatch(**{k: torch.as_tensor(v, device=dev)
                        for k, v in cols.items()})
        outs.append(coalesce_msg_batch(b, n_slots, KernelDelivery()))
    got, want = outs
    for k in ("part", "slot", "src_part", "valid", "cnt"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    absum = np.zeros((C, d))
    keys = cols["part"] * n_slots + cols["slot"]
    live_keys = np.unique(keys[cols["valid"]])
    for r, key in enumerate(live_keys):
        absum[r] = np.abs(cols["vec"][cols["valid"] & (keys == key)]).sum(0)
    err = (got.vec.cpu() - want.vec).abs().numpy()
    assert (err <= KA_TOL * (1 + absum)).all()


# the gated tick and the training plane on the card against the CPU, at
# tests/test_delta_gating.py's and test_train_plane.py's sizes: integer
# stats, steps and fire ticks exactly equal; the sink, losses and
# last_grad within 1e-4 x (1 + |cpu|) (f32 sums in another order)
def _gated_run(device, driver, backend):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = _golden_stream()
    pipe = D3Pipeline(GraphSAGE((8, 12, 12), seed=0), PipelineConfig(
        n_parts=4, node_cap=32, edge_cap=128, repl_cap=128, feat_cap=128,
        edge_tick_cap=32, max_nodes=32, delta_eps=1e-3,
        delivery_backend=backend,
        window=win.WindowConfig(kind=win.STREAMING)), device=device)
    rng = np.random.default_rng(7)
    cur = dict(feats)
    if driver == "tick":
        pipe.run_stream(edges, feats, tick_edges=24)
        pipe.flush(max_ticks=96)
    else:
        pipe.run_stream_super(edges, feats, tick_edges=24, super_ticks=4)
        pipe.flush_super(max_ticks=96, T=4)
    for _ in range(4):
        wave = []
        for v in sorted(cur):
            dv = rng.normal(size=8).astype(np.float32)
            cur[v] = cur[v] + dv * (2e-4 / np.linalg.norm(dv))
            wave.append((v, cur[v]))
        if driver == "tick":
            pipe.tick(feats=wave)
        else:
            pipe.run_super_tick(feat_chunks=[wave], T=1)
    if driver == "tick":
        pipe.flush(max_ticks=96)
    else:
        pipe.flush_super(max_ticks=96, T=4)
    m = {k: v for k, v in vars(pipe.metrics).items() if isinstance(v, int)}
    return m, pipe.sink.cpu()


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_gated_tick_on_the_card_matches_the_cpu(cuda, driver, backend):
    torch.backends.cuda.matmul.allow_tf32 = False
    got_m, got = _gated_run(cuda, driver, backend)
    want_m, want = _gated_run(torch.device("cpu"), driver, backend)
    assert got_m == want_m and got_m["suppressed"] > 0
    assert bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all())


def _train_run(device, driver, backend):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.core.train_plane import TrainConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.serve.train_session import TrainSession
    edges, feats = _golden_stream()
    labels = {v: (v * 7 + 3) % 4 for v in range(32)}
    pipe = D3Pipeline(
        GraphSAGE((8, 16, 16), seed=0, n_classes=4), PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=32, train_cap=64,
            delivery_backend=backend,
            window=win.WindowConfig(kind=win.STREAMING)),
        train=TrainConfig(optimizer=sgd(), lr=0.1, batch_threshold=4),
        device=device)
    sess = TrainSession(pipe, driver=driver, super_ticks=4)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    sess.observe_labels(labels)
    steps = []
    for e, f in zip(e_chunks, f_chunks):
        sess.step(e, f)
        steps.append(sess.train_stats()["steps"])
    for _ in range(3):
        sess.observe_labels(labels)
        sess.flush()
        steps.append(sess.train_stats()["steps"])
    st = sess.train_stats()
    return steps, st, [g.cpu() for g in tree_leaves(
        pipe.train_state.last_grad)]


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_train_plane_on_the_card_matches_the_cpu(cuda, driver, backend):
    torch.backends.cuda.matmul.allow_tf32 = False
    sr_ops.reset_launches()
    got = _train_run(cuda, driver, backend)
    want = _train_run(torch.device("cpu"), driver, backend)
    assert got[0] == want[0] and got[1]["steps"] > 0
    for k in ("loss", "grad_norm"):
        assert abs(got[1][k] - want[1][k]) <= 1e-4 * (1 + abs(want[1][k]))
    for a, b in zip(got[2], want[2]):
        assert bool(((a - b).abs() <= 1e-4 * (1 + b.abs())).all())
    if backend == "kernel":
        assert sr_ops.LAUNCHES["segment_sum_rows"] > 0


# the telemetry plane and consistent-cut checkpoints on the card
def _tel_run(device, driver, backend, telemetry=True):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    edges, feats = _golden_stream()
    pipe = D3Pipeline(GraphSAGE((8, 12, 12), seed=0), PipelineConfig(
        n_parts=4, node_cap=32, edge_cap=128, repl_cap=128, feat_cap=128,
        edge_tick_cap=32, max_nodes=32, query_cap=8, telemetry=telemetry,
        delivery_backend=backend,
        window=win.WindowConfig(kind=win.SESSION, interval=3)),
        device=device)
    e_chunks, f_chunks = pipe.chunk_stream(edges, feats, 24)
    q = [(1, 0, int(edges[0, 0]), True), (2, 0, 5, False)]
    if driver == "tick":
        stats = [pipe.tick(e, f, queries=q if i == 1 else None)
                 for i, (e, f) in enumerate(zip(e_chunks, f_chunks))]
        stats += [pipe.tick() for _ in range(8)]
    else:
        stats = [pipe.run_super_tick(e_chunks, f_chunks, T=len(e_chunks),
                                     query_chunks=[None, q])[0],
                 pipe.run_super_tick(T=8)[0]]
    return pipe, stats


@pytest.mark.parametrize("backend", ["kernel", "scatter"])
@pytest.mark.parametrize("driver", ["tick", "super"])
def test_telemetry_gauges_on_the_card_match_the_cpu(cuda, driver, backend):
    """Every occupancy row and integer trace column card = CPU; with
    telemetry off the card's stats other than the gauges and its sink are
    bit-equal to the telemetry-on run."""
    from repro_torch.core.tick import SCALAR_FIELDS
    from repro_torch.telemetry.trace import TRACE_DEVICE_COLS
    got, _ = _tel_run(cuda, driver, backend)
    want, _ = _tel_run(torch.device("cpu"), driver, backend)
    a, b = got.trace.columns(), want.trace.columns()
    for c in TRACE_DEVICE_COLS + ["tick", "edges_in", "feats_in",
                                  "queries_in", "amortized"]:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)
    assert a["q_admitted"].sum() == 2 and a["emitted_sum"].sum() > 0
    on, s_on = _tel_run(cuda, driver, backend)
    off, s_off = _tel_run(cuda, driver, backend, telemetry=False)
    for x, y in zip(s_on, s_off):
        for sx, sy in zip(x, y):
            for f in SCALAR_FIELDS:
                if f not in ("occ_bc_defer", "occ_rmi_defer", "route_peak",
                             "outbox_part_peak"):
                    assert int(getattr(sx, f)) == int(getattr(sy, f)), f
    assert torch.equal(on.sink, off.sink)


@pytest.mark.parametrize("direction", ["card-to-cpu", "cpu-to-card"])
def test_checkpoint_moves_between_the_card_and_the_cpu(cuda, tmp_path,
                                                       direction):
    """A checkpoint written on one device restores on the other; the
    continuation's answers and integer stats equal the writer's."""
    from repro_torch.ft.checkpoint import CheckpointManager
    cpu = torch.device("cpu")
    src_dev, dst_dev = ((cuda, cpu) if direction == "card-to-cpu"
                        else (cpu, cuda))
    edges, feats = _golden_stream()
    src, _ = _tel_run(src_dev, "tick", "kernel")
    mgr = CheckpointManager(tmp_path)
    mgr.save_pipeline(1, src)
    dst, _ = _tel_run(dst_dev, "tick", "kernel")
    assert mgr.restore_pipeline(dst) == 1
    assert dst.sink.device.type == dst_dev.type
    assert torch.equal(dst.sink.cpu(), src.sink.cpu())
    more = edges[:30][:, ::-1].copy()
    cut = [(p.metrics.reduce_msgs, p.metrics.emitted_total)
           for p in (src, dst)]
    for p in (src, dst):
        p.drain_answers()
        p.tick(more, [(int(v), feats[int(v)]) for v in np.unique(more)],
               queries=[(7, 0, int(more[0, 0]), True)])
        p.flush(max_ticks=64)
    a, b = src.drain_answers(), dst.drain_answers()
    for k in ("qid", "ok", "tick"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (np.abs(a["vec"] - b["vec"]) <= 1e-5 * (1 + np.abs(b["vec"]))).all()
    deltas = [(p.metrics.reduce_msgs - r, p.metrics.emitted_total - e)
              for p, (r, e) in zip((src, dst), cut)]
    assert deltas[0] == deltas[1] and deltas[0][0] > 0


# the 2-D stage pipeline and the live reshard on 4 gloo ranks sharing the
# card, each case also run on the CPU over the same groups: integer stats
# and metrics exactly equal, embeddings and sinks within 1e-5 x (1 +
# |cpu|) (f32 sums of the same records in another order); kernels 1-3
# launched on the card ranks
def _stage_card_rank(world, driver):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import make_stream_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    edges, feats = _golden_stream()
    mesh = make_stream_mesh(world.device, stage=2)
    out = {}
    for dev in (world.device, torch.device("cpu")):
        rp_ops.reset_launches()
        sr_ops.reset_launches()
        pipe = D3Pipeline(GraphSAGE((8, 8, 8), seed=0), PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=32, n_stages=2,
            route_cap=4, window=win.WindowConfig(kind=win.STREAMING)),
            mesh=mesh.on(dev))
        if driver == "tick":
            pipe.run_stream(edges, feats, tick_edges=24)
            pipe.flush(max_ticks=160)
        else:
            pipe.run_stream_super(edges, feats, tick_edges=24,
                                  super_ticks=4)
            pipe.flush_super(max_ticks=160, T=4)
        out[dev.type] = {
            "metrics": {k: v for k, v in vars(pipe.metrics).items()
                        if isinstance(v, int)},
            "emb": pipe.embeddings(),
            "launches": {**rp_ops.LAUNCHES, **sr_ops.LAUNCHES}}
    return out


@pytest.mark.parametrize("driver", ["tick", "super"])
def test_stage_program_on_the_card_matches_the_cpu(cuda, driver):
    from repro_torch.launch.mesh import spawn_stream_mesh
    for r in spawn_stream_mesh(4, _stage_card_rank, backend="gloo",
                               device=cuda, stage=2, args=(driver,),
                               timeout=300):
        a, b = r["cuda"], r["cpu"]
        assert a["metrics"] == b["metrics"]
        assert a["metrics"]["stage_idle"] > 0
        assert a["metrics"]["route_deferred"] > 0
        assert a["metrics"]["route_dropped"] == 0
        assert set(a["emb"]) == set(b["emb"]) and a["emb"]
        for v, vec in b["emb"].items():
            assert (np.abs(a["emb"][v] - vec)
                    <= 1e-5 * (1 + np.abs(vec))).all()
        assert all(a["launches"][k] > 0 for k in (
            "route_lane", "segment_sum_rows", "mean_rows_gather"))
        assert all(v == 0 for v in b["launches"].values())


def _reshard_card_rank(world, case):
    from repro_torch.core import windowing as win
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch.mesh import make_stream_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    S, old, new = case
    edges, feats = _golden_stream(n_edges=150)
    chunks = [edges[i:i + 16] for i in range(0, len(edges), 16)]
    rows = [[(int(v), feats[int(v)]) for e in c for v in set(map(int, e))]
            for c in chunks]
    out = {}
    for dev in (world.device, torch.device("cpu")):
        mk = lambda n: make_stream_mesh(dev, stage=S, ranks=range(n * S))
        pipe = D3Pipeline(GraphSAGE((8, 8, 8), seed=0), PipelineConfig(
            n_parts=4, node_cap=32, edge_cap=128, repl_cap=128,
            feat_cap=128, edge_tick_cap=32, max_nodes=32, n_stages=S,
            window=win.WindowConfig(kind=win.SESSION, interval=3)),
            mesh=mk(old))
        for i, (c, f) in enumerate(zip(chunks, rows)):
            if i == len(chunks) // 2:
                pipe.reshard(mk(new))
            if pipe.active:
                pipe.tick(c, f)
        if not pipe.active:
            out[dev.type] = None
            continue
        pipe.flush(max_ticks=128)
        out[dev.type] = {
            "metrics": {k: v for k, v in vars(pipe.metrics).items()
                        if isinstance(v, int)},
            "sink": pipe.sink_global().cpu().numpy(),
            "device": pipe.sink.device.type}
    return out


@pytest.mark.parametrize("case", [(1, 4, 2), (1, 2, 4), (2, 2, 1)],
                         ids=["4-to-2", "2-to-4", "2x2-to-2x1"])
def test_reshard_on_the_card_matches_the_cpu(cuda, case):
    """A mid-stream reshard relays the carry card to card: the result
    equals the same reshard of CPU tensors."""
    from repro_torch.launch.mesh import spawn_stream_mesh
    held = 0
    for r in spawn_stream_mesh(4, _reshard_card_rank, backend="gloo",
                               device=cuda, args=(case,), timeout=300):
        a, b = r["cuda"], r["cpu"]
        assert (a is None) == (b is None)
        if a is None:
            continue
        held += 1
        assert a["device"] == "cuda" and a["metrics"] == b["metrics"]
        assert a["metrics"]["route_dropped"] == 0
        assert (np.abs(a["sink"] - b["sink"])
                <= 1e-5 * (1 + np.abs(b["sink"]))).all()
    S, _, new = case
    assert held == S * new


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_partial_on_the_card(cuda, dtype):
    """The sequence-sharded decode on the card: 4 shards' partials,
    combined, equal the whole-cache decode (bf16: within bf16's 2^-8,
    the whole-cache decode rounds its weights and output to bf16; f32:
    1e-5) and the same functions on the CPU."""
    from repro_torch.nn.attention import (combine_partial_decodes,
                                          decode_attend,
                                          decode_attend_partial)
    rng = np.random.default_rng(3)
    B, T, Kh, G, D = 2, 1024, 8, 4, 128
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((B, 1, Kh * G, D), (B, T, Kh, D), (B, T, Kh, D)))
    valid = torch.as_tensor(rng.random((B, T)) > 0.1)
    valid[1, 3 * T // 4:] = False            # a whole shard masked
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        qd, kd, vd = (x.to(dev, dtype) for x in (q, k, v))
        vm = valid.to(dev)
        n = T // 4
        parts = [decode_attend_partial(qd, kd[:, i * n:(i + 1) * n],
                                       vd[:, i * n:(i + 1) * n],
                                       vm[:, i * n:(i + 1) * n])
                 for i in range(4)]
        comb = combine_partial_decodes(*(torch.stack(x)
                                         for x in zip(*parts)))
        full = decode_attend(qd, kd, vd, vm).float()
        assert torch.isfinite(comb).all()
        assert ((comb - full).abs() <= tol * torch.clamp(full.abs(), min=1)
                ).all()
        outs[dev.type] = comb.cpu()
    assert ((outs["cuda"] - outs["cpu"]).abs()
            <= tol * torch.clamp(outs["cpu"].abs(), min=1)).all()


# the zoo's train steps. Kernel 4 under autograd: its backward (kernel 1
# over the sorted flat ids) equals the plain table gradient (zeros +
# index_add_) within KA_TOL x (1 + the row's sum of |w| / count), kernel
# A's bound above (f32 sums of the same rows in another order: a hub row
# sums thousands); every kernel entry without a backward raises under
# grad
@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("B,W,V,d,hub", [(300, 8, 1000, 32, False),
                                        (4096, 8, 5000, 256, True)])
def test_embedding_bag_backward_on_the_card_matches_plain(cuda, mode, B, W,
                                                         V, d, hub):
    g = torch.Generator().manual_seed(B + d)
    ids = torch.randint(-2, V, (B, W), generator=g)
    ids[:5] = -1                           # empty bags
    ids[5, 0] = V + 7                      # a NaN bag: no gradient row
    if hub:                                # one row named by a third of ids
        ids[torch.rand(B, W, generator=g) < 0.3] = 17
    table = torch.randn(V, d, generator=g)
    w = torch.randn(B, d, generator=g)
    w[5] = 0.0
    leaf = table.to(cuda).requires_grad_()
    eb_ops.reset_launches()
    sr_ops.reset_launches()
    out = eb_ops.embedding_bag(leaf, ids.to(cuda), mode)
    (got,) = torch.autograd.grad((out.nan_to_num() * w.to(cuda)).sum(),
                                 leaf)
    assert eb_ops.LAUNCHES["embedding_bag"] == 1
    assert sr_ops.LAUNCHES["segment_sum_rows"] == 1
    want = eb_ref.embedding_bag_grad_ref(w, ids, V, mode)
    mag = eb_ref.embedding_bag_grad_ref(w.abs(), ids, V, mode)
    err = (got.cpu() - want).abs()
    assert bool((err <= KA_TOL * (1 + mag)).all()), float(err.max())
    direct = eb_ops.embedding_bag_grad(w.to(cuda), ids.to(cuda), V, mode)
    torch.testing.assert_close(direct, got, rtol=0, atol=0)


def test_kernel_entries_without_a_backward_raise_under_grad(cuda):
    q = torch.randn(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="mha_chunked"):
        ops.flash_attention(q.requires_grad_(), k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape
    vec = torch.randn(6, 3, device=cuda, requires_grad=True)
    row_ptr = torch.tensor([0, 2, 6], device=cuda)
    with pytest.raises(RuntimeError, match="deliver_rows.*no backward"):
        sr_ops.deliver_rows(vec, row_ptr)
    with pytest.raises(RuntimeError, match="mean_rows_gather.*no backward"):
        sr_ops.mean_rows_gather(vec, torch.ones(6, device=cuda),
                                torch.zeros(2, dtype=torch.int64,
                                            device=cuda))
    order = torch.arange(6, device=cuda)
    with pytest.raises(RuntimeError, match="route_pack.*no backward"):
        rp_ops.route_pack(vec, order, order, torch.tensor(
            [0, 6, 6], device=cuda), 2, 3)
    lane = FeatBatch(part=torch.zeros(6, dtype=torch.int64, device=cuda),
                     slot=torch.zeros(6, dtype=torch.int64, device=cuda),
                     feat=vec, valid=torch.ones(6, dtype=torch.bool,
                                                device=cuda))
    W = sum(w for _, _, _, w in wire.lane_fields(lane))
    plan = rp_ops.route_plan(lane.part, lane.valid, 2, 3)
    with pytest.raises(RuntimeError, match="route_lane.*no backward"):
        rp_ops.route_lane(torch.zeros(0, W, device=cuda), lane, plan, 2, 3)
    with torch.no_grad():
        sr_ops.deliver_rows(vec, row_ptr)
        rp_ops.route_lane(torch.zeros(0, W, device=cuda), lane, plan, 2, 3)


def _copy_train_model(spec, cuda):
    cpu = spec.build_reduced(device="cpu", seed=0, train=True)
    card = spec.build_reduced(device=cuda, seed=1, train=True)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _assert_train_runs_match(cpu_runs, card_runs):
    """Loss within 1e-5 x |cpu|; parameters and Adam moments within 1e-5
    absolute, and the moments also within 1e-4 x max |cpu| per leaf (the
    CPU parity tests' bounds against JAX: v ~ 1e-3 g^2 lies far below
    1e-5)."""
    for (lc, pc, sc), (lg, pg, sg) in zip(cpu_runs, card_runs):
        assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
        for name in pc:
            for a, b in ((pc, pg), (sc["m"], sg["m"]), (sc["v"], sg["v"])):
                err = float((b[name].cpu() - a[name]).abs().max())
                assert err <= 1e-5, (name, err)
            for a, b in ((sc["m"], sg["m"]), (sc["v"], sg["v"])):
                err = float((b[name].cpu() - a[name]).abs().max())
                assert err <= 1e-4 * float(a[name].abs().max()), (name, err)
        assert int(sg["t"]) == int(sc["t"])


def test_reduced_lm_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.data.streams import token_batches
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_arch("mistral-nemo-12b")
    cpu, card = _copy_train_model(spec, cuda)
    runs = {}
    for model in (cpu, card):
        step = spec.step(model, "train_4k")
        p = param_tree(model)
        s = adam().init(p)
        runs[model.device.type] = out = []
        ops.reset_launches()
        for toks, labels in token_batches(0, model.cfg.vocab, 256, 32, 2):
            p, s, loss = step(p, s, torch.as_tensor(toks, device=model.device),
                              torch.as_tensor(labels, device=model.device))
            out.append((loss, p, s))
        assert ops.LAUNCHES["flash_attention"] == 0
    _assert_train_runs_match(runs["cpu"], runs["cuda"])


def test_reduced_two_tower_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import random_bag_ids
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_arch("two-tower-retrieval")
    cpu, card = _copy_train_model(spec, cuda)
    c = cpu.cfg
    g = torch.Generator().manual_seed(0)
    batches = [{"user_ids": random_bag_ids(g, (256, c.user_fields,
                                               c.max_ids_per_field),
                                           c.user_vocab),
                "item_ids": random_bag_ids(g, (256, c.item_fields,
                                               c.max_ids_per_field),
                                           c.item_vocab),
                "item_logq": torch.randn(256, generator=g) - 5.0}
               for _ in range(2)]
    runs = {}
    for model in (cpu, card):
        step = spec.step(model, "train_batch")
        p = param_tree(model)
        s = adam().init(p)
        runs[model.device.type] = out = []
        eb_ops.reset_launches()
        sr_ops.reset_launches()
        for b in batches:
            p, s, loss = step(p, s, {k: v.to(model.device)
                                     for k, v in b.items()})
            out.append((loss, p, s))
    assert eb_ops.LAUNCHES["embedding_bag"] == 4      # 2 towers x 2 steps
    assert sr_ops.LAUNCHES["segment_sum_rows"] == 4   # their backwards
    _assert_train_runs_match(runs["cpu"], runs["cuda"])


@pytest.mark.parametrize("arch,shape", [
    ("mistral-nemo-12b", "train_4k"), ("two-tower-retrieval", "train_batch"),
    ("gatedgcn", "full_graph_sm"), ("dimenet", "molecule")])
def test_train_cli_runs_on_the_card_by_default(cuda, arch, shape, capsys):
    from repro_torch.launch import train
    model, params, state, losses = train.main(
        ["--arch", arch, "--shape", shape, "--reduced", "--steps", "3"])
    assert next(iter(params.values())).is_cuda
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert capsys.readouterr().out.strip().endswith("train driver done")


# gather_segment_sum / rmi_apply_read (kernels A and B at the reference's
# fused-graph and fused apply-and-read entries) against their plain
# versions run in float64 (the f32 plain version's one-at-a-time
# index_add_ drifts where a run repeats rows: chip_smoke.gss_within): per
# element |diff| <= KA_TOL * (1 + the row's sum of magnitudes); counts,
# dirty flags exact; the mean read within that / max(cnt, 1) + 1e-6
@pytest.mark.parametrize("N,E,d,case", [
    (100, 400, 16, "masked"), (300, 5000, 75, "shuffled"),
    (64, 3000, 602, "hub"), (64, 300, 8, "all_masked"), (64, 0, 8, "none"),
    (1000, 20000, 1, "masked"), (5000, 60000, 602, "repeats")])
def test_gather_segment_sum_matches_plain(cuda, N, E, d, case):
    rng = np.random.default_rng(N + E + d)
    x = torch.as_tensor(rng.normal(size=(N, d)).astype(np.float32))
    s = torch.as_tensor(rng.integers(0, N, E))
    r = torch.full((E,), 7) if case == "hub" else \
        torch.as_tensor(rng.integers(0, N, E))
    if case == "repeats":      # a hub that reads a few rows many times
        s = s % 8
        r = torch.where(torch.as_tensor(rng.random(E) < 0.5), 3, r)
    mask = torch.as_tensor(rng.random(E) > 0.3)
    if case == "all_masked":
        mask[:] = False
    if case == "shuffled":
        r = r.sort().values[torch.as_tensor(rng.permutation(E))]
    sr_ops.reset_launches()
    got = sr_ops.gather_segment_sum(x.to(cuda), s.to(cuda), r.to(cuda), N,
                                    mask.to(cuda))
    torch.cuda.synchronize()
    assert sr_ops.LAUNCHES["segment_sum_rows"] == 1
    want = sr_ref.gather_segment_sum_ref(x.double(), s, r, N, mask)
    mag = sr_ref.gather_segment_sum_ref(x.abs(), s, r, N, mask)
    err = (got.cpu().double() - want).abs()
    assert bool((err <= KA_TOL * (1 + mag)).all()), float(err.max())


@pytest.mark.parametrize("R,C,K,d", [(70, 50, 12, 6), (4096, 30000, 512, 64),
                                     (2048, 9000, 300, 602), (16, 0, 4, 3)])
def test_rmi_apply_read_matches_plain(cuda, R, C, K, d):
    rng = np.random.default_rng(R + C)
    agg = torch.as_tensor(rng.normal(size=(R, d)).astype(np.float32))
    cnt = torch.as_tensor(rng.integers(-1, 4, R).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, R + R // 8 + 1, C))
    vec = torch.as_tensor(rng.normal(size=(C, d)).astype(np.float32))
    dcnt = torch.as_tensor(rng.integers(-1, 2, C).astype(np.float32))
    ridx = torch.as_tensor(rng.integers(0, R, K))
    sr_ops.reset_launches()
    got = sr_ops.rmi_apply_read(*(t.to(cuda) for t in (agg, cnt, idx, vec,
                                                       dcnt, ridx)))
    torch.cuda.synchronize()
    assert sr_ops.LAUNCHES == {"segment_sum_rows": 1, "mean_rows_gather": 1}
    want = sr_ref.rmi_apply_read_ref(agg.double(), cnt.double(), idx,
                                     vec.double(), dcnt.double(), ridx)
    mag = sr_ref.rmi_apply_read_ref(agg.abs(), cnt, idx, vec.abs(), dcnt,
                                    ridx)[0]
    assert bool(((got[0].cpu().double() - want[0]).abs()
                 <= KA_TOL * (1 + mag)).all())
    assert torch.equal(got[1].cpu().double(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    # the reads divide rows that agree within the bound above
    n = want[1][ridx].clamp(min=1)[:, None]
    assert bool(((got[3].cpu().double() - want[3]).abs()
                 <= KA_TOL * (1 + mag[ridx]) / n + 1e-6 * (1 + want[3].abs()))
                .all())


def test_gather_and_apply_read_raise_under_grad(cuda):
    x = torch.randn(8, 4, device=cuda, requires_grad=True)
    e = torch.tensor([0, 1, 2], device=cuda)
    with pytest.raises(RuntimeError, match="gather_segment_sum.*no backward"):
        sr_ops.gather_segment_sum(x, e, e, 8)
    with pytest.raises(RuntimeError, match="rmi_apply_read.*no backward"):
        sr_ops.rmi_apply_read(x, torch.ones(8, device=cuda), e,
                              torch.ones(3, 4, device=cuda),
                              torch.ones(3, device=cuda), e)
    with torch.no_grad():
        assert sr_ops.gather_segment_sum(x, e, e, 8).shape == (8, 4)


# Mixture-of-Experts on the card: plain PyTorch (JAX computes the
# dispatch outside any Pallas kernel), held to the CPU run of the same
# layer at the CPU parity tests' f32 bound, 1e-5 * (1 + |cpu|), TF32 off.
# The tokens and the router sit on a grid (x in k / 8, router in j / 64,
# 32-wide rows) so the router logits are exact on both devices and every
# (token, expert) pair routes alike, drops included.
def _moe_grid_case(E=4, K=2, T=96, cf=1.25, n_shared=1, seed=0):
    from repro_torch.nn.moe import MoEConfig, MoELayer
    g = torch.Generator().manual_seed(seed)
    lay = MoELayer(32, MoEConfig(num_experts=E, top_k=K, d_ff=16,
                                 n_shared=n_shared, capacity_factor=cf),
                   device="cpu", generator=g)
    with torch.no_grad():
        lay.router.copy_(torch.randint(-32, 33, (32, E), generator=g) / 64)
        lay.router[:4, :2] += 1.0
    x = torch.randint(-16, 17, (T, 32), generator=g) / 8.0
    x[:, :4] += 1.0                      # leans toward experts 0 and 1
    return lay, x


def test_moe_ties_and_dispatch_on_the_card_match_the_cpu(cuda):
    import copy
    torch.backends.cuda.matmul.allow_tf32 = False
    lay, x = _moe_grid_case()
    card = copy.deepcopy(lay).to(cuda)
    ids_cpu = lay.route(x)[0]
    assert torch.equal(card.route(x.to(cuda))[0].cpu(), ids_cpu)
    dropped = int((torch.bincount(ids_cpu.reshape(-1), minlength=4)
                   - int(96 * 2 * 1.25 / 4)).clamp(min=0).sum())
    assert dropped > 0
    for fn in ("forward", "dense_oracle"):
        want, aux = getattr(lay, fn)(x)
        got, aux_card = getattr(card, fn)(x.to(cuda))
        err = (got.cpu() - want).abs()
        assert bool((err <= 1e-5 * (1 + want.abs())).all()), (fn, err.max())
        assert abs(float(aux_card) - float(aux)) <= 1e-5 * float(aux)
    # ties: a zero router makes every expert equally likely, and the lower
    # indices win on both devices, as jax.lax.top_k orders them
    with torch.no_grad():
        card.router.zero_()
    assert torch.equal(card.route(x.to(cuda))[0].cpu(),
                       torch.tensor([[0, 1]] * 96))


def _moe_ep_card_rank(mesh, sd, x, cf):
    from repro_torch.nn.moe import MoEConfig, MoELayer
    outs = {}
    for name, m in (("card", mesh), ("cpu", mesh.on("cpu"))):
        lay = MoELayer(32, MoEConfig(num_experts=4, top_k=2, d_ff=16,
                                     n_shared=1, capacity_factor=cf,
                                     ep_axis=("model",)), device=m.device)
        lay.load_state_dict(sd)
        T = x.shape[0] // m.size
        xl = x[m.rank * T:(m.rank + 1) * T].to(m.device)
        with torch.no_grad():
            outs[name] = lay(xl, mesh=m)[0].cpu()
    return outs


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_ep_on_the_card_matches_the_cpu(cuda, cf):
    """2 gloo ranks on the card: the EP outputs equal the same ranks' CPU
    run, and at capacity_factor 8 (nothing drops) the dense oracle."""
    from repro_torch.launch.mesh import spawn_stream_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    lay, x = _moe_grid_case()
    ranks = spawn_stream_mesh(2, _moe_ep_card_rank, backend="gloo",
                              device="cuda", args=(lay.state_dict(), x, cf),
                              timeout=300)
    got = torch.cat([r["card"] for r in ranks])
    want = torch.cat([r["cpu"] for r in ranks])
    assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())
    if cf == 8.0:
        oracle = lay.dense_oracle(x)[0].detach()
        assert bool(((got - oracle).abs() <= 1e-5 * (1 + oracle.abs()))
                    .all())


def _locality_card_rank(mesh, sd, plan, x, labels, local):
    from repro_torch.dist.gnn_locality import (make_locality_train_step,
                                               rank_batch)
    from repro_torch.graph.pna import PNA
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    out = {}
    for name, m in (("card", mesh), ("cpu", mesh.on("cpu"))):
        model = PNA(8, 16, 2, 4, 1.5, device=m.device)
        model.load_state_dict(sd)
        step = make_locality_train_step(model, 4, m, local_update=local)
        params = param_tree(model)
        batch = rank_batch(plan, m.rank, x, labels, np.ones(len(labels),
                                                             bool), m.device)
        new, _, loss = step(params, adam().init(params), batch)
        out[name] = (float(loss), {k: v.cpu() for k, v in new.items()})
    return out


@pytest.mark.parametrize("local", [False, True])
def test_locality_step_on_the_card_matches_the_cpu(cuda, local):
    """tests/test_torch_locality.py's graph on 4 gloo ranks sharing the
    card: loss within 1e-5 * max(1, |cpu|), updated parameters within
    1e-5 of the same ranks' CPU run."""
    from repro_torch.dist.gnn_locality import build_plan
    from repro_torch.graph.pna import PNA
    from repro_torch.launch.mesh import spawn_stream_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 64, 300), rng.integers(0, 64, 300)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    labels = rng.integers(0, 4, 64)
    sd = PNA(8, 16, 2, 4, 1.5, device="cpu").state_dict()
    ranks = spawn_stream_mesh(4, _locality_card_rank, backend="gloo",
                              device="cuda",
                              args=(sd, build_plan(s, r, 64, 4), x, labels,
                                    local), timeout=300)
    for out in ranks:
        lc, pc = out["cpu"]
        lg, pg = out["card"]
        assert abs(lg - lc) <= 1e-5 * max(1.0, abs(lc))
        for k in pc:
            assert float((pg[k] - pc[k]).abs().max()) <= 1e-5, k


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_reduced_moe_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.configs import get_arch
    from repro_torch.data.streams import token_batches
    from repro_torch.nn.module import param_tree
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_arch(arch)
    cpu, card = _copy_train_model(spec, cuda)
    runs = {}
    for model in (cpu, card):
        step = spec.step(model, "train_4k")
        p = param_tree(model)
        s = adam().init(p)
        runs[model.device.type] = out = []
        for toks, labels in token_batches(0, model.cfg.vocab, 256, 32, 2):
            p, s, loss = step(p, s, torch.as_tensor(toks, device=model.device),
                              torch.as_tensor(labels, device=model.device))
            out.append((loss, p, s))
    _assert_train_runs_match(runs["cpu"], runs["cuda"])


# ------------------------------------------------------------ tooling
def test_analyzer_reads_the_plain_flops_through_kernels_5_and_4(cuda):
    """The roofline's count does not change when a kernel replaces its
    plain version: flash attention (wgmma, bf16 D = 128) is charged the
    causal pairs' products, 4 B H D S (S + 1) / 2, as the plain version
    is through its aten products on the card less their masked share,
    and fewer bytes (no scores); the bag lookup no FLOPs, as its plain
    gather, and fewer bytes."""
    from repro_torch.roofline.analysis import analyze_step
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, H, Kh, D = 1, 512, 8, 2, 128
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=cuda,
                           dtype=torch.bfloat16) for h in (H, Kh, Kh))
    ops.reset_launches()
    kern = analyze_step(ops.flash_attention, q, k, v)
    plain = analyze_step(ref.attention_ref, q, k, v)
    assert ops.LAUNCHES["flash_attention_wgmma"] == 1
    causal = 4 * B * H * D * S * (S + 1) // 2
    assert kern["op_flops"] == plain["op_flops"] == causal
    assert kern["op_masked_flops"] == 0
    assert plain["op_flops"] + plain["op_masked_flops"] == 4 * B * H * S * S * D
    assert kern["op_bytes"] < plain["op_bytes"]
    table = torch.randn(10_000, 256, generator=g, device=cuda)
    ids = torch.randint(-1, 10_000, (512, 8), generator=g, device=cuda)
    eb_ops.reset_launches()
    kern = analyze_step(eb_ops.embedding_bag, table, ids)
    plain = analyze_step(eb_ref.embedding_bag_ref, table, ids)
    assert eb_ops.LAUNCHES["embedding_bag"] == 1
    assert kern["op_flops"] == plain["op_flops"] == 0
    assert 0 < kern["op_bytes"] < plain["op_bytes"]


def test_dryrun_card_cell_of_a_reduced_lm_prefill(cuda, tmp_path,
                                                  monkeypatch):
    """`run_cell(..., device="cuda")` on mistral-nemo-12b's prefill cell
    with the REDUCED model (f32, 4 layers): a JSON with the card's peak
    memory, the step's seconds and the flash launches counted."""
    import json
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    spec = get_arch("mistral-nemo-12b")
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "get_arch", lambda a: replace(
        spec, build=spec.build_reduced))
    r = dryrun.run_cell("mistral-nemo-12b", "prefill_32k", False,
                        device="cuda")
    saved = json.loads((tmp_path / "mistral-nemo-12b__prefill_32k__card"
                        ".json").read_text())
    assert saved["peak_memory_gb"] > 0 and saved["step_s"] > 0
    assert saved["kernels"]["flash_attention"]["calls"] == 4
    assert r["reduced"]["batch"] == {"published": 32, "run": 1}
