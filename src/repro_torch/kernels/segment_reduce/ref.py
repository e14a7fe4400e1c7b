"""Plain PyTorch versions of the segment-reduce kernels.

The wrappers in `ops.py` run these for CPU tensors; `chip_smoke.py` holds
the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregators import mean_read


def segment_sum_rows_ref(rows, seg, row_ptr):
    """out[r] = sum(rows[row_ptr[r]:row_ptr[r + 1]]) for destination-sorted
    rows [E, W] with sorted segment ids seg [E] and run offsets row_ptr
    [n + 1]; empty runs read zero and rows at or past row_ptr[n] are
    padding."""
    n = row_ptr.numel() - 1
    live = int(row_ptr[-1])
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, seg[:live], rows[:live])


def mean_rows_gather_ref(agg, cnt, rows):
    """out[k] = agg[rows[k]] / max(cnt[rows[k]], 1), zero where cnt <= 0."""
    return mean_read(agg[rows], cnt[rows])
