"""Flash-attention wrapper: checks in PyTorch, attention in CUDA.

Counterpart of `repro/kernels/flash_attention/ops.py:flash_attention`
(GQA layout in, GQA layout out). The kernel, `csrc/flash_attention.cu`,
replaces kernel.py:flash_attention_kernel and reads the GQA layout from its
strides, so nothing is transposed or broadcast here.

The wrapper runs its plain version (`ref.py`) for CPU tensors and, for
CUDA tensors, launches the kernel or raises. `LAUNCHES` counts kernel
launches (a plain integer; `reset_launches()` zeroes it) so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURE = [_P] * 4 + [_I] * 19 + [ctypes.c_float, _I, _P]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("flash_attention")
    lib.d3_flash_attention.argtypes = _SIGNATURE
    lib.d3_flash_attention.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,S,H,D] and k, v [B,T,Kh,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    Bk, T, Kh, Dk = k.shape
    if Bk != B or Dk != D or Kh == 0 or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         "not share batch and head dim, or H % Kh != 0")
    if T == 0:
        raise ValueError("attention over an empty key sequence")


def _check_cuda(q, k, v) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"the kernel takes bf16 or f32 q, k, v of one "
                         f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte rows for cp.async: last dim contiguous, strides in 16 B
        per16 = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"in multiples of 16 bytes and a 16-byte "
                             f"aligned start; strides {t.stride()}")


def flash_attention(q, k, v, causal: bool = True):
    """GQA flash attention. q [B,S,H,D]; k/v [B,T,Kh,D] -> [B,S,H,D] in
    q.dtype. Causal: key t is visible to query s iff t <= s (both from
    0)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    _check_cuda(q, k, v)
    B, S, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if B * S * H == 0:
        return out
    rc = _lib().d3_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, Kh, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], int(causal), 1.0 / D ** 0.5,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    LAUNCHES["flash_attention"] += 1
    return out
