"""Masked segment reductions — the message-passing primitive.

Counterpart of `repro/graph/segment.py`. All ops take `data [E, ...]`,
`segment_ids [E]` (int64), `num_segments` and an optional boolean `mask
[E]` for padded edges. Invalid edges contribute nothing; `segment_ids` of
padded edges may be arbitrary in [0, num_segments). A segment with no
valid edge reads 0 (segment_std: sqrt(eps)).

These are plain PyTorch (`index_add_`, `scatter_reduce`) on every device,
as the JAX package computes them with `jax.ops.segment_*` outside any
Pallas kernel. `segment_max` ties split the gradient evenly among the
tied elements, as `jax.ops.segment_max`'s does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked(data, mask, fill=0.0):
    if mask is None:
        return data
    return torch.where(mask.reshape(mask.shape + (1,) * (data.ndim - 1)),
                       data, torch.full((), fill, dtype=data.dtype,
                                        device=data.device))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, _masked(data, mask))


def segment_count(segment_ids, num_segments: int, mask=None, dtype=None):
    ones = torch.ones(segment_ids.shape, dtype=dtype or torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def _per_row(n, like):
    """[S] counts shaped to broadcast against a [S, ...] table."""
    return n.reshape(n.shape + (1,) * (like.ndim - 1))


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    s = segment_sum(data, segment_ids, num_segments, mask)
    n = segment_count(segment_ids, num_segments, mask, dtype=s.dtype)
    return s / torch.clamp(_per_row(n, s), min=1.0)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Per-segment max; masked edges are NEG_INF, and a segment whose max
    is at or below NEG_INF / 2 (no valid edge) reads 0."""
    d = _masked(data, mask, NEG_INF)
    idx = segment_ids.reshape(segment_ids.shape + (1,) * (d.ndim - 1))
    m = torch.full((num_segments,) + tuple(d.shape[1:]), float("-inf"),
                   dtype=d.dtype, device=d.device)
    m = m.scatter_reduce(0, idx.expand_as(d), d, "amax", include_self=False)
    return torch.where(m <= NEG_INF / 2, torch.zeros((), dtype=m.dtype,
                                                     device=m.device), m)


def segment_min(data, segment_ids, num_segments: int, mask=None):
    return -segment_max(-data, segment_ids, num_segments, mask)


def segment_std(data, segment_ids, num_segments: int, mask=None,
                eps: float = 1e-5):
    """Per-segment standard deviation (PNA's std aggregator), from the
    invertible synopsis (Σm, Σm², n): sqrt(max(Σm²/n - (Σm/n)², 0) + eps),
    n clamped to 1."""
    s1 = segment_sum(data, segment_ids, num_segments, mask)
    s2 = segment_sum(torch.square(data), segment_ids, num_segments, mask)
    n = segment_count(segment_ids, num_segments, mask, dtype=s1.dtype)
    n = _per_row(torch.clamp(n, min=1.0), s1)
    var = s2 / n - torch.square(s1 / n)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    return torch.sqrt(torch.maximum(var, torch.zeros((), dtype=var.dtype,
                                                     device=var.device))
                      + eps)


def segment_softmax(scores, segment_ids, num_segments: int, mask=None):
    """Edge softmax per destination segment (GAT / attention aggregators),
    over each trailing column independently; masked edges get 0."""
    m = segment_max(scores, segment_ids, num_segments, mask)
    z = torch.exp(_masked(scores - m[segment_ids], mask, NEG_INF))
    denom = segment_sum(z, segment_ids, num_segments)
    return z / torch.clamp(denom[segment_ids], min=1e-30)
