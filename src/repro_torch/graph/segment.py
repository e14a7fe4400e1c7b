"""Masked segment reductions for the static oracle.

Counterpart of `repro/graph/segment.py` (`segment_sum`/`segment_mean`
only). Invalid (masked) edges contribute nothing.
"""
from __future__ import annotations

import torch


def _masked(data, mask):
    if mask is None:
        return data
    return torch.where(mask.reshape(mask.shape + (1,) * (data.ndim - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, _masked(data, mask))


def segment_count(segment_ids, num_segments: int, mask=None, dtype=None):
    ones = torch.ones(segment_ids.shape, dtype=dtype or torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    s = segment_sum(data, segment_ids, num_segments, mask)
    n = segment_count(segment_ids, num_segments, mask, dtype=s.dtype)
    n = n.reshape(n.shape + (1,) * (s.ndim - 1))
    return s / torch.clamp(n, min=1.0)
