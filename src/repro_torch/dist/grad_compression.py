"""Compressed gradient exchange with error feedback.

Counterpart of `repro/dist/grad_compression.py`: top-k sparsification plus
int8 quantization, where the part of the gradient compression discarded
is carried in a per-leaf residual and added back before the next step
(error feedback). `compress_decompress` returns the reconstructed
gradient, so a caller drops it into any optimizer.

`batched=True` treats each leaf's leading axis as independent instances,
as JAX's `vmap` of the compressor over the training plane's part axis:
top-k and the int8 scale are per instance. Rounding is half-to-even, as
`jnp.round`. Top-k keeps every value at or above the k-th largest
magnitude, so which of several tied values `torch.topk` lists last does
not change the result.
"""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_map


def quantize_int8(x, dim=None):
    """Symmetric int8: q = round(x / s), s = max|x| / 127 (over `dim`, the
    whole tensor when None)."""
    amax = (torch.amax(torch.abs(x)) if dim is None
            else torch.amax(torch.abs(x), dim=dim, keepdim=True))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def init_error_feedback(grads):
    """Residual tree (the gradients' structure), all zeros."""
    return tree_map(torch.zeros_like, grads)


def _compress_leaf(g, res, int8: bool, topk_frac: float, batched: bool):
    """One leaf: error-feedback add, top-k mask, optional int8 round-trip.
    Returns (reconstructed update, new residual) in g's resp. res's dtype;
    the accumulator runs in f32."""
    acc = g.to(torch.float32) + res.to(torch.float32)
    flat = acc.reshape(acc.shape[0], -1) if batched else acc.reshape(1, -1)
    k = max(1, int(flat.shape[1] * topk_frac))
    thresh = torch.topk(torch.abs(flat), k, dim=1).values[:, -1:]
    mask = torch.abs(flat) >= thresh
    kept = torch.where(mask, flat, 0.0)
    if int8:
        q, s = quantize_int8(kept, dim=1)
        sent = torch.where(mask, dequantize_int8(q, s), 0.0)
    else:
        sent = kept
    new_res = flat - sent
    return (sent.reshape(acc.shape).to(g.dtype),
            new_res.reshape(acc.shape).to(res.dtype))


def compress_decompress(grads, residual, int8: bool = True,
                        topk_frac: float = 0.25, batched: bool = False):
    """Compress gradients with error feedback; returns (sent,
    new_residual), sent being the decompressed update applied this
    step."""
    out = tree_map(lambda g, r: _compress_leaf(g, r, int8, topk_frac,
                                               batched), grads, residual)
    # the grads' structure picks each leaf's (sent, residual) pair apart
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))
