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
