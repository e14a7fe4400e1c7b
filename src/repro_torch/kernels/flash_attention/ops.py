"""Flash-attention wrapper: checks in PyTorch, attention in CUDA.

Counterpart of `repro/kernels/flash_attention/ops.py:flash_attention`
(GQA layout in, GQA layout out). The kernel, `csrc/flash_attention.cu`,
replaces kernel.py:flash_attention_kernel and reads the GQA layout from its
strides, so nothing is transposed or broadcast here.

The source holds three kernels, and the wrapper picks one by dtype and
head dim: bf16 at D in `WGMMA_HEAD_DIMS` (64, 128; the model's 128) goes
to the Hopper kernel (TMA ring, warp-specialised producer, wgmma
consumers), bf16 at D 16 or 32 to the mma.sync kernel, f32 (D in
`F32_HEAD_DIMS`, 8 too: the reduced internlm2-20b and mistral-large-123b
configs' head dim) to the CUDA-core kernel. The wrapper runs its plain version (`ref.py`) for CPU
tensors and, for CUDA tensors, launches the chosen kernel or raises: it
never drops back to another kernel or to the plain version.

On the `meta` device (the dry run's) the wrapper checks and allocates
its output and launches nothing: the kernel's shape function. Each call
notes its operands (`repro_torch.work.note`) for an operation counter
to price.

`LAUNCHES` counts kernel launches (plain integers; `reset_launches()`
zeroes them) so a run can show that its path went through the kernels:
"flash_attention" every launch, "flash_attention_wgmma" those of the
Hopper kernel.

The kernels have no backward (nor has the JAX package's: its model
never trains through the Pallas kernel, `use_flash` is never set), so on
CUDA tensors the wrapper raises under autograd rather than return an
output without a graph: training attends through
`nn/attention.py:mha_chunked`, as JAX's does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import work
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}

HEAD_DIMS = (16, 32, 64, 128)
F32_HEAD_DIMS = (8,) + HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# a TMA tensor map takes byte strides below 2^40
_TMA_STRIDE_LIMIT = 1 << 40

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURE = [_P] * 4 + [_I] * 19 + [ctypes.c_float, _I, _P]
_WGMMA_SIGNATURE = [_P] * 4 + [_I] * 19 + [ctypes.c_float, _P]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("flash_attention")
    lib.d3_flash_attention.argtypes = _SIGNATURE
    lib.d3_flash_attention.restype = ctypes.c_int
    lib.d3_flash_attention_wgmma.argtypes = _WGMMA_SIGNATURE
    lib.d3_flash_attention_wgmma.restype = ctypes.c_int
    lib.d3_flash_attention_wgmma_smem.argtypes = [_I]
    lib.d3_flash_attention_wgmma_smem.restype = ctypes.c_int
    return lib


def wgmma_smem_bytes(D: int) -> int:
    """The wgmma kernel's dynamic shared memory at head dim D (builds the
    library)."""
    return _lib().d3_flash_attention_wgmma_smem(D)


def uses_wgmma(q) -> bool:
    """Whether a CUDA call with this q goes to the Hopper (wgmma) kernel."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS


def _map_strides(t) -> list:
    """t's [b, s, h] strides (elements) as its tensor map takes them: a
    dimension of size 1 is never stepped, so it gets the stride a
    contiguous tensor would have."""
    B, L, Hd, D = t.shape
    natural = (L * Hd * D, Hd * D, D)
    return [st if n > 1 else nat
            for st, n, nat in zip(t.stride()[:3], t.shape[:3], natural)]


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
    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    if q.shape[-1] not in dims:
        raise ValueError(f"head dim {q.shape[-1]} not in {dims} "
                         f"({q.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte rows for cp.async and TMA: last dim contiguous, strides
        # in 16 B
        per16 = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"in multiples of 16 bytes and a 16-byte "
                             f"aligned start; strides {t.stride()}")
        if uses_wgmma(q) and not all(
                s * t.element_size() < _TMA_STRIDE_LIMIT
                for s in _map_strides(t)):
            raise ValueError(f"{name}'s tensor map needs strides below "
                             f"2^40 bytes on dims longer than 1; strides "
                             f"{t.stride()}")


def flash_attention(q, k, v, causal: bool = True):
    """GQA flash attention. q [B,S,H,D]; k/v [B,T,Kh,D] -> [B,S,H,D] in
    q.dtype. Causal: key t is visible to query s iff t <= s (both from
    0)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    _check_cuda(q, k, v)
    cuda_lib.refuse_grad("flash_attention (training attends through "
                         "nn.attention.mha_chunked, as the JAX package's "
                         "does)", q, k, v)
    wgmma = uses_wgmma(q)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() and q.device.type != "meta":
        _launch(q, k, v, out, causal, wgmma)
        LAUNCHES["flash_attention"] += 1
        LAUNCHES["flash_attention_wgmma"] += int(wgmma)
    if out.numel():
        work.note("flash_attention", q=q, k=k, v=v, out=out, causal=causal)
    return out


def _launch(q, k, v, out, causal, wgmma) -> None:
    """One kernel on checked, non-empty CUDA tensors; raises on any
    error it returns."""
    B, S, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, Kh, D, *_map_strides(q), *_map_strides(k),
            *_map_strides(v), *out.stride()[:3], int(causal), 1.0 / D ** 0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if wgmma:
        rc = lib.d3_flash_attention_wgmma(*args, stream)
    else:
        rc = lib.d3_flash_attention(*args, _DTYPE_CODES[q.dtype], stream)
    if rc < 0:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled "
                           f"refused a tensor map: CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")


def _flash_attention_mma_sync(q, k, v, causal: bool = True):
    """The mma.sync kernel on bf16 CUDA tensors at D 16, 32 or 128:
    chip_smoke.py's yardstick for the wgmma kernel at D = 128. Counts no
    launch; nothing on the serve path calls it."""
    _check(q, k, v)
    _check_cuda(q, k, v)
    if q.dtype != torch.bfloat16 or q.device.type != "cuda":
        raise ValueError("the mma.sync kernel takes bf16 CUDA tensors")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel():
        _launch(q, k, v, out, causal, wgmma=False)
    return out
