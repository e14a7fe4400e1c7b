"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without an NVIDIA GPU (the kernels build
with nvcc at first launch). This file imports neither jax nor the JAX
package, so it runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the same kernels to their plain versions at the
models' shapes; these are the small cases.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.route_pack import ops as rp_ops, ref as rp_ref

pytestmark = pytest.mark.cuda

# bf16: both round the output to bf16 (one ulp is 2^-7 relative); f32:
# sums in another order
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=1e-4, atol=2e-5)}


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


def test_flash_attention_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda, dtype=torch.bfloat16)
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
