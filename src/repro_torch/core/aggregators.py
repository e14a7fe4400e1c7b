"""Incremental streaming aggregators (paper §4.2.1).

Counterpart of `repro/core/aggregators.py` (`mean_read`). The engine
represents reduce / replace / remove as one additive delta record
(delta_vec, delta_cnt), so the MEAN synopsis is (sigma, n) and its read is
sigma / n.
"""
from __future__ import annotations

import torch


def mean_read(agg_sum, agg_cnt):
    """Read the MEAN synopsis; rows with n <= 0 read zeros (a neighborhood
    emptied by remove/replace RMIs may keep a float residual in sigma)."""
    cnt = agg_cnt[..., None]
    return torch.where(cnt > 0, agg_sum / torch.clamp(cnt, min=1.0),
                       torch.zeros((), dtype=agg_sum.dtype,
                                   device=agg_sum.device))
