"""The port's flash-attention wrapper (repro_torch.kernels.flash_attention)
against the JAX package, on the CPU, where the wrapper runs its plain
PyTorch version: against the Pallas `flash_attention` in interpret mode at
the shapes of tests/test_kernels.py, and against the JAX oracles
(`attention_ref`, `gqa_attention_ref`) on ragged and S != T cases the
Pallas kernel's block asserts do not take.

Tolerances: rtol 1e-4 / atol 2e-5 in f32 (the bound test_kernels.py holds
the Pallas kernel to); 5e-2 in bf16 (the JAX oracle rounds the scores to
bf16, the kernel and the port keep them in f32).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.kernels.flash_attention.ref import gqa_attention_ref
from repro_torch.kernels.flash_attention import ops, ref

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _qkv(seed, B, S, T, H, Kh, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, T, Kh, D)).astype(np.float32),
            rng.normal(size=(B, T, Kh, D)).astype(np.float32))


def _port(q, k, v, causal=True, dtype=torch.float32):
    return ops.flash_attention(*(torch.as_tensor(a).to(dtype)
                                 for a in (q, k, v)), causal=causal)


@pytest.mark.parametrize("B,S,H,Kh,D,bq,bk", [
    (2, 128, 4, 2, 32, 64, 64),
    (1, 256, 8, 8, 16, 128, 64),
    (2, 64, 4, 1, 64, 64, 64),
    (1, 512, 2, 2, 128, 256, 256),
])
def test_matches_jax_flash_shapes(B, S, H, Kh, D, bq, bk):
    q, k, v = _qkv(S + H, B, S, S, H, Kh, D)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=bq, block_k=bk)
    got = _port(q, k, v)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_matches_jax_flash_noncausal():
    q, k, v = _qkv(0, 1, 128, 128, 2, 2, 32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, block_q=64, block_k=64)
    np.testing.assert_allclose(_port(q, k, v, causal=False).numpy(),
                               np.asarray(want), **F32_TOL)


def test_matches_jax_flash_bf16():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 128, 4, 32)).astype(np.float32)
    k = rng.normal(size=(1, 128, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, 128, 2, 32)).astype(np.float32)
    want = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v)), causal=True, block_q=64,
                     block_k=64)
    got = _port(q, k, v, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("S,T,causal", [
    (100, 100, True),     # ragged: no block of 64 divides S
    (77, 77, False),
    (50, 130, False),     # S != T
    (130, 50, False),
    (70, 130, True),      # causal with S != T: key t visible iff t <= s
])
def test_ragged_matches_jax_attention_ref(S, T, causal):
    B, H, D = 2, 3, 16
    q, k, v = _qkv(S * T, B, S, T, H, H, D)
    fold = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
        B * H, a.shape[1], D))
    want = np.asarray(jax_ref(fold(q), fold(k), fold(v), causal=causal))
    want = want.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_port(q, k, v, causal=causal).numpy(), want,
                               **F32_TOL)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_ragged_matches_jax_gqa_ref(D, causal):
    """G = 4 query heads per KV head, S = T = 97 (ragged), every head dim
    the kernel takes."""
    q, k, v = _qkv(D, 1, 97, 97, 8, 2, D)
    want = gqa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(_port(q, k, v, causal=causal).numpy(),
                               np.asarray(want), **F32_TOL)


def test_query_chunks_do_not_change_the_result():
    """The plain version's query-chunk loop (q_chunk < S, ragged last
    chunk) computes the same function as one chunk."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(5, 1, 90, 90, 4, 2, 32))
    whole = ref.attention_ref(q, k, v, causal=True, q_chunk=90)
    np.testing.assert_allclose(
        ref.attention_ref(q, k, v, causal=True, q_chunk=32).numpy(),
        whole.numpy(), **F32_TOL)


def test_cpu_wrapper_counts_no_launch():
    ops.reset_launches()
    _port(*_qkv(3, 1, 16, 16, 2, 1, 16))
    assert ops.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("shapes", [
    ((1, 8, 4, 16), (1, 8, 3, 16)),      # H % Kh != 0
    ((1, 8, 4, 16), (2, 8, 2, 16)),      # batch differs
    ((1, 8, 4, 16), (1, 8, 2, 32)),      # head dim differs
    ((1, 8, 4, 16), (1, 0, 2, 16)),      # no keys
])
def test_wrapper_rejects_bad_shapes(shapes):
    qs, ks = shapes
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(qs), torch.zeros(ks),
                            torch.zeros(ks))


@pytest.mark.parametrize("case", ["f16", "mixed", "head_dim", "last_stride",
                                  "odd_stride"])
def test_cuda_checks_reject_what_the_kernel_does_not_take(case):
    """The checks a CUDA call passes before launching (run here on CPU
    tensors: they read only dtype, shape and strides)."""
    q = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    v = k.clone()
    if case == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        q = q.float()
    elif case == "head_dim":
        q, k, v = q[..., :24], k[..., :24].contiguous(), v[..., :24]
    elif case == "last_stride":
        q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)[..., ::2]
    elif case == "odd_stride":
        q = torch.zeros(1, 8, 4, 33, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError):
        ops._check_cuda(q, k, v)
    ops._check_cuda(torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16),
                    torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16),
                    torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16))

