"""Embedding-bag wrapper: checks in PyTorch, gather and reduce in CUDA.

Counterpart of `repro/kernels/embedding_bag/ops.py:embedding_bag`. The
kernel, `csrc/embedding_bag.cu`, replaces kernel.py:embedding_bag_kernel
and the `jnp.take` gather before it: it reads each valid row once and
reduces it into its bag, so no [B*W, d] intermediate exists. Unlike the
JAX wrapper it takes any bag count (the Pallas kernel asserts
B % min(64, B) == 0).

Under autograd (grad mode on and the table requiring grad) the lookup is
a `torch.autograd.Function` whose backward is the table gradient, as
`jnp.take`'s is in the JAX package: a sum of rows per destination row,
kernel 1's semantics, so on the card it runs on `csrc/segment_reduce.cu`
(`segment_reduce.ops.sort_runs` + `deliver_rows`, as
`core/delivery.py:KernelDelivery.add_rows` calls them). No gradient flows
to the ids.

The wrapper runs its plain versions (`ref.py`) for CPU tensors and, for
CUDA tensors, launches the kernels or raises. On the `meta` device (the dry
run's) each entry allocates its output and launches nothing; each
kernel call notes its operands (`repro_torch.work.note`) for an
operation counter to price. `LAUNCHES` counts kernel
launches (a plain integer; `reset_launches()` zeroes it) so a run can show
that its path went through the kernel; the backward's launches count
under kernel 1's `segment_reduce.ops.LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import work
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.embedding_bag import ref
from repro_torch.kernels.segment_reduce import ops as seg_ops

LAUNCHES = {"embedding_bag": 0}

_ID_DTYPES = {torch.int32: 0, torch.int64: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURE = [_P, _P, _P] + [_I] * 6 + [_P]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("embedding_bag")
    lib.d3_embedding_bag.argtypes = _SIGNATURE
    lib.d3_embedding_bag.restype = ctypes.c_int
    return lib


def _check(table, ids, mode: str) -> None:
    if mode not in ref.MODES:
        raise ValueError(f"mode {mode!r} not in {ref.MODES}")
    if table.ndim != 2 or ids.ndim != 2:
        raise ValueError(f"need table [V, d] and ids [B, W]; got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)}")
    if ids.dtype not in _ID_DTYPES:
        raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")


def _forward(table, ids, mode: str):
    """The bags, no graph: the plain version on the CPU, the kernel on
    the card."""
    if table.device.type == "cpu":
        return ref.embedding_bag_ref(table, ids, mode)
    if table.dtype != torch.float32:
        raise ValueError(f"the kernel takes an f32 table, got {table.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    (V, d), (B, W) = table.shape, ids.shape
    out = torch.empty(B, d, dtype=torch.float32, device=table.device)
    if B * d == 0:
        return out
    work.note("embedding_bag", ids=ids, out=out)
    if table.device.type == "meta":
        return out
    rc = _lib().d3_embedding_bag(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), V, d, B, W,
        _ID_DTYPES[ids.dtype], int(mode == "mean"),
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag launch failed: cudaError {rc}")
    LAUNCHES["embedding_bag"] += 1
    return out


def embedding_bag_grad(grad_out, ids, n_rows: int, mode: str = "mean"):
    """The table gradient of `embedding_bag`: grad_out [B, d] f32, ids
    [B, W] -> dense [n_rows, d] f32 (semantics of
    `ref.embedding_bag_grad_ref`).

    On the card, kernel 1 in its gather form: the flat ids sorted stably
    by row (`sort_runs`; padding and ids past the table sort past every
    run), each sorted record reading its bag's row of grad_out (scaled
    by 1 / max(#ids >= 0, 1) in mean mode) by index, so no [B * W, d]
    rows are written; rows no id names read 0."""
    if grad_out.device.type == "cpu":
        return ref.embedding_bag_grad_ref(grad_out, ids, n_rows, mode)
    B, W = ids.shape
    g = grad_out.to(torch.float32)
    g = g / ref.bag_counts(ids)[:, None] if mode == "mean" \
        else g.contiguous()
    order, row_ptr = seg_ops.sort_runs(ids.reshape(-1).to(torch.int64),
                                       n_rows)
    out, _, _ = seg_ops.deliver_rows(g, row_ptr, order // W, mode="add")
    return out


class _EmbeddingBag(torch.autograd.Function):
    """The lookup under autograd: forward `_forward`, backward
    `embedding_bag_grad` into the table (none into the ids)."""

    @staticmethod
    def forward(table, ids, mode):
        return _forward(table, ids, mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids, mode = inputs
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.mode = table.shape[0], mode

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        return (embedding_bag_grad(grad_out, ids, ctx.n_rows, ctx.mode),
                None, None)


def embedding_bag(table, ids, mode: str = "mean"):
    """table [V, d] f32; ids [B, W] int32/int64, negative = padding ->
    [B, d] f32 (semantics of `ref.embedding_bag_ref`). Differentiable in
    the table."""
    _check(table, ids, mode)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, ids, mode)
    return _forward(table, ids, mode)
