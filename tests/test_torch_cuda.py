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
